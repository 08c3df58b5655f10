"""TCGA-BRCA 4-subtype finetuning driver on the port (counterpart of the
repository's ``scripts/train_tcga.py``): a thin driver over
``dgdm_histopath_torch.cli.train`` for the molecular-subtyping task (4
classes: LumA / LumB / Her2 / Basal) with its overrides.

    python -m dgdm_histopath_torch.scripts.train_tcga --data-dir /data/tcga_graphs \\
        --metadata /data/tcga_brca_labels.csv --output-dir ./tcga_run

It trains on the card unless ``--cpu`` is given.
"""

import argparse
import sys
from pathlib import Path

from ..cli.train import main as train_main

SUBTYPES = ["LumA", "LumB", "Her2", "Basal"]
DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "dgdm_base.yaml"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train_tcga", description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True,
                   help="directory of preprocessed *_graph.npz TCGA graphs")
    p.add_argument("--metadata", required=True, help="slide_id,label csv")
    p.add_argument("--output-dir", default="./tcga_brca_run")
    p.add_argument("--config", default=str(DEFAULT_CONFIG))
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--pretrain-epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = p.parse_args(argv)

    cli_args = [
        "train",
        "--config", args.config,
        "--data-dir", args.data_dir,
        "--dataset-type", "graph",
        "--metadata", args.metadata,
        "--output-dir", args.output_dir,
        "--num-classes", str(len(SUBTYPES)),
        "--max-epochs", str(args.max_epochs),
        "--pretrain-epochs", str(args.pretrain_epochs),
        "--batch-size", str(args.batch_size),
        "--learning-rate", str(args.learning_rate),
        "--device", "cpu" if args.cpu else "cuda",
    ]
    if args.devices:
        cli_args += ["--devices", str(args.devices)]
    print(f"TCGA-BRCA subtyping: {SUBTYPES}")
    return train_main(cli_args)


if __name__ == "__main__":
    sys.exit(main())
