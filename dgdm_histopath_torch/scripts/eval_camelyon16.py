"""CAMELYON16 accuracy-parity evaluation, staged end to end, on the port
(counterpart of the repository's ``scripts/eval_camelyon16.py``).

The reference's headline claim is CAMELYON16 metastasis-detection AUC 0.976
(F1 0.932) for DGDM-Base and 0.984 for DGDM-Large. Reproducing it needs two
artifacts: pretrained DINOv2 weights (timm's ``vit_base_patch14_dinov2.
lvd142m``, converted once with ``python -m dgdm_histopath_torch.scripts.
convert_timm_vit dinov2_b14.pth dinov2_b14.npz``) and the CAMELYON16 slides
(``<root>/training/normal/normal_*.tif``, ``<root>/training/tumor/
tumor_*.tif``, ``<root>/testing/images/test_*.tif`` and
``<root>/testing/reference.csv`` of slide_id,label rows, label in
{Normal, Tumor}):

    python -m dgdm_histopath_torch.scripts.eval_camelyon16 \\
        --data-root /data/camelyon16 --vit-weights dinov2_b14.npz --out results/c16

``--synthetic`` runs the same pipeline (discovery, tissue detection,
patching, featurization, graph build, finetuning, slide-level AUC / F1) on
generated stand-in slides; ``--synthetic --hard`` is the calibrated hard
gate (focal lesions against benign mimics, per-slide baseline and stain
jitter, 5% train label noise), the recipe of ``docs/results/c16_hard``:

    python -m dgdm_histopath_torch.scripts.eval_camelyon16 --synthetic --hard \\
        --out c16 --n-train-per-class 48 --n-test-per-class 64 --extractor stats \\
        --per-slide-norm --selection final --hidden 256,128,64 --dropout 0.2 \\
        --lr 1e-3 --weight-decay 1e-3 --finetune-lr-factor 1.0 \\
        --pretrain-epochs 4 --finetune-epochs 40 --train-seed 0,1,2 --ab-pretrain

Synthetic slides are rendered on the host with the JAX package's pixels
(the numpy renderer of ``preprocessing/synthetic.py``, in parallel
processes), and only those whose graphs are not in ``--out/graph_cache``
yet: a directory holding the generation's ``manifest.json`` and the cached
graphs trains without any slide file. Featurization, the kNN graph build,
training and prediction run on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

from . import resolve
from .gate_harness import slide_to_graph  # noqa: F401  (shared helper, re-exported)

REFERENCE_TARGETS = {  # the reference README's accuracy table
    "base": {"auc": 0.976, "f1": 0.932},
    "large": {"auc": 0.984, "f1": None},
}


def _listed(root: Path, pattern: str, listed: Iterable[Path]) -> list:
    """The files of ``pattern`` under ``root``, with the ``listed`` slides
    that match it counted as present, sorted."""
    found = set(root.glob(pattern))
    for p in listed:
        try:
            if p.relative_to(root).match(pattern):
                found.add(p)
        except ValueError:
            continue
    return sorted(found)


def discover_camelyon16(root: Path, listed: Iterable[Path] = ()):
    """Return (train_items, test_items) of (path, label) with label 1=tumor.
    ``listed``: slides to count as present whether or not their file exists
    (synthetic slides whose rendering waits for a graph-cache miss)."""
    listed = list(listed)
    train = []
    for sub, label in (("normal", 0), ("tumor", 1)):
        for pat in (f"training/{sub}/*.tif*", f"training/{sub}_*.tif*"):
            for p in _listed(root, pat, listed):
                train.append((p, label))
    test = []
    ref_csv = root / "testing" / "reference.csv"
    labels = {}
    if ref_csv.exists():
        with open(ref_csv) as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    labels[row[0].strip()] = 1 if row[1].strip().lower() in (
                        "tumor", "1", "metastases") else 0
    for p in _listed(root, "testing/images/*.tif*", listed):
        if p.stem in labels:
            test.append((p, labels[p.stem]))
    return train, test


def _write_or_defer(path: Path, params: dict, jobs: Optional[Dict[Path, dict]]) -> None:
    if path.exists():
        return
    if jobs is None:
        from ..preprocessing.synthetic import write_synthetic_tiff
        write_synthetic_tiff(path, **params)
    else:
        jobs[path] = params


def generate_synthetic_camelyon16(root: Path, n_per_class: int = 10,
                                  n_test_per_class: int = 8, size: int = 2048,
                                  jobs: Optional[Dict[Path, dict]] = None) -> None:
    """Stand-in dataset in the CAMELYON16 directory layout; tumor slides get
    ~8x the nuclei density. ``jobs``, where given, receives the slides to
    write ({path: kwargs}) instead of their being written here."""
    rows = []
    seed = 0
    for split, n in (("training", n_per_class), ("testing", n_test_per_class)):
        for label, name, dens in ((0, "normal", 0.0008), (1, "tumor", 0.0065)):
            for i in range(n):
                seed += 1
                if split == "training":
                    p = root / "training" / name / f"{name}_{i:03d}.tiff"
                else:
                    p = root / "testing" / "images" / f"test_{label}{i:03d}.tiff"
                    rows.append((p.stem, "Tumor" if label else "Normal"))
                _write_or_defer(p, dict(width=size, height=size, num_levels=3, seed=seed,
                                        nuclei_density=dens), jobs)
    ref = root / "testing" / "reference.csv"
    ref.parent.mkdir(parents=True, exist_ok=True)
    with open(ref, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def generate_synthetic_camelyon16_hard(root: Path, n_train_per_class: int = 32,
                                       n_test_per_class: int = 64, size: int = 1024,
                                       seed: int = 0, label_noise: float = 0.05,
                                       jobs: Optional[Dict[Path, dict]] = None,
                                       **param_overrides) -> dict:
    """The calibrated-difficulty stand-in benchmark: focal lesions (one
    focus at 2.1-2.7x the slide's own baseline density) against benign
    mimics (1.2-1.7x), a 3x per-slide baseline spread, stain / scanner
    jitter and ``label_noise`` of the training slides filed in the wrong
    class. The per-slide parameters come from
    ``preprocessing.synthetic.sample_hard_slide_params`` (``param_overrides``
    pass through). Returns the generation manifest, written to
    ``root/manifest.json``; ``jobs`` as in :func:`generate_synthetic_camelyon16`."""
    from ..preprocessing.synthetic import HARD_TASK_DEFAULTS, sample_hard_slide_params
    rows, manifest = [], []
    rs_noise = np.random.RandomState(seed + 777)
    idx = 0
    for split, n in (("training", n_train_per_class), ("testing", n_test_per_class)):
        for true_label, name in ((0, "normal"), (1, "tumor")):
            for _ in range(n):
                idx += 1
                rs = np.random.RandomState(seed * 100003 + idx)
                params = sample_hard_slide_params(rs, bool(true_label), size=size,
                                                  seed=seed + idx, **param_overrides)
                params["num_levels"] = 3
                filed_label = true_label
                if split == "training" and rs_noise.rand() < label_noise:
                    filed_label = 1 - true_label  # noisy training label
                if split == "training":
                    dirname = "normal" if filed_label == 0 else "tumor"
                    p = root / "training" / dirname / f"{dirname}_{idx:04d}.tiff"
                else:
                    p = root / "testing" / "images" / f"test_{idx:04d}.tiff"
                    rows.append((p.stem, "Tumor" if true_label else "Normal"))
                _write_or_defer(p, params, jobs)
                manifest.append({"slide": p.stem, "split": split,
                                 "true_label": true_label, "filed_label": filed_label,
                                 "baseline_density": round(params["nuclei_density"], 6),
                                 "focal_density": round(params["focal_density"], 6),
                                 "focal_frac": round(params["focal_frac"], 4)})
    ref = root / "testing" / "reference.csv"
    ref.parent.mkdir(parents=True, exist_ok=True)
    with open(ref, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    task_params = dict(HARD_TASK_DEFAULTS)
    task_params.update(param_overrides)
    man = {"task": "c16-hard-standin", "seed": seed, "size": size,
           "n_train": 2 * n_train_per_class, "n_test": 2 * n_test_per_class,
           "label_noise": label_noise,
           "params": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in task_params.items()},
           "slides": manifest}
    root.mkdir(parents=True, exist_ok=True)
    (root / "manifest.json").write_text(json.dumps(man, indent=1))
    return man


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eval_camelyon16", description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", type=Path, default=None,
                    help="CAMELYON16 root (training/, testing/)")
    ap.add_argument("--vit-weights", type=Path, default=None,
                    help="converted DINOv2 npz (scripts/convert_timm_vit.py)")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate stand-in slides and run the full loop")
    ap.add_argument("--hard", action="store_true",
                    help="with --synthetic: the calibrated hard stand-in benchmark "
                         "(focal lesions vs benign mimics, 3x baseline-density "
                         "jitter, stain/scanner jitter, 5%% train label noise, "
                         "n_test=128); the legacy --synthetic task saturates at AUC 1.0")
    ap.add_argument("--n-train-per-class", type=int, default=32)
    ap.add_argument("--n-test-per-class", type=int, default=64)
    ap.add_argument("--slide-size", type=int, default=None,
                    help="synthetic slide edge in px (default 1024 hard / 2048 easy)")
    ap.add_argument("--ab-pretrain", action="store_true",
                    help="also train a from-scratch variant (0 pretrain epochs, same "
                         "finetune budget) and report the paired AUC delta: the "
                         "transfer-benefit gate of the SSL phase")
    ap.add_argument("--out", type=Path, default=Path("c16_eval"))
    ap.add_argument("--report-name", default="report.json",
                    help="report filename under --out")
    ap.add_argument("--config", choices=("base", "large"), default="base")
    ap.add_argument("--bucket", type=int, default=None,
                    help="node bucket (default: 1024 base / 2048 large; synthetic 256)")
    ap.add_argument("--max-patches", type=int, default=None)
    ap.add_argument("--patch-size", type=int, default=None,
                    help="default 256; synthetic staging uses 64")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--pretrain-epochs", type=int, default=None)
    ap.add_argument("--finetune-epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="peak learning rate (default: 1e-4 with pretrained ViT "
                         "weights, 1e-3 otherwise)")
    ap.add_argument("--extractor", default=None,
                    help="patch featurizer arch (default: dinov2; synthetic staging "
                         "defaults to simple_cnn; 'stats' = the 14-d stain-morphometry "
                         "features)")
    ap.add_argument("--per-slide-norm", action="store_true",
                    help="z-score node features within each slide")
    ap.add_argument("--hidden", default=None,
                    help="override model hidden dims, comma-separated (the calibrated "
                         "hard gate uses 256,128,64)")
    ap.add_argument("--dropout", type=float, default=None,
                    help="override model dropout (default 0.1)")
    ap.add_argument("--weight-decay", type=float, default=None,
                    help="AdamW weight decay (default TrainerConfig 1e-5; the hard gate "
                         "uses 1e-3)")
    ap.add_argument("--finetune-lr-factor", type=float, default=None,
                    help="LR multiplier at the pretrain->finetune transition "
                         "(TrainerConfig default 0.1; short-pretrain runs need 1.0)")
    ap.add_argument("--selection", choices=("val_loss", "final"), default="val_loss",
                    help="'val_loss' = early stopping and the best-val-loss "
                         "parameters restored; 'final' = the full budget, final "
                         "parameters (the hard gate's)")
    ap.add_argument("--window", type=str, default=None,
                    help="the windowed config: spatial_window + graph_window = W, "
                         "graphs Morton-sorted and built with knn_window=W; a comma "
                         "list ('32,8') adds one arm per window, the first the "
                         "promoted one")
    ap.add_argument("--ab-window", action="store_true",
                    help="with --window: train the dense config too and report both")
    ap.add_argument("--ab-int8", action="store_true",
                    help="after training, also evaluate the dense arm's parameters "
                         "through the int8 Dense path and report the AUC delta")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="also train an MoE variant (DGDMModel(moe_experts=N))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-seed", type=str, default=None,
                    help="seed(s) of the training procedure only (train/val split, "
                         "shuffling, parameter init); the data keeps --seed. A comma "
                         "list runs every seed in one process. Defaults to --seed.")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--prep-only", action="store_true",
                    help="generate the data and build the graph caches of every "
                         "scheduled graph-build config, then exit")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve(ap, args.cpu)

    from ..models.vit import PatchFeatureExtractor
    from ..preprocessing import SlideProcessor
    from .gate_harness import GateSpec, render_slides, run_gate

    t_start = time.time()
    args.out.mkdir(parents=True, exist_ok=True)
    jobs: Dict[Path, dict] = {}
    if args.synthetic:
        data_root = args.out / "synthetic_data"
        print(f"[eval_c16] synthetic stand-in data at {data_root}")
        if args.hard:
            generate_synthetic_camelyon16_hard(
                data_root, n_train_per_class=args.n_train_per_class,
                n_test_per_class=args.n_test_per_class, seed=args.seed,
                size=args.slide_size or 1024, jobs=jobs)
        else:
            generate_synthetic_camelyon16(data_root, size=args.slide_size or 2048, jobs=jobs)
        bucket = args.bucket or 256
        max_patches = args.max_patches or 256
        patch_size = args.patch_size or 64
        tissue_threshold = 0.3
        pretrain_epochs = ((4 if args.hard else 1) if args.pretrain_epochs is None
                           else args.pretrain_epochs)
        finetune_epochs = 30 if args.finetune_epochs is None else args.finetune_epochs
    else:
        if args.data_root is None:
            ap.error("--data-root required without --synthetic")
        data_root = args.data_root
        bucket = args.bucket or (2048 if args.config == "large" else 1024)
        max_patches = args.max_patches or (2000 if args.config == "large" else 1000)
        patch_size = args.patch_size or 256
        tissue_threshold = 0.5
        pretrain_epochs = 50 if args.pretrain_epochs is None else args.pretrain_epochs
        finetune_epochs = 50 if args.finetune_epochs is None else args.finetune_epochs

    train_items, test_items = discover_camelyon16(data_root, listed=jobs)
    if not train_items or not test_items:
        sys.exit(f"no slides found under {data_root} (expected CAMELYON16 "
                 f"layout: training/normal|tumor, testing/images + reference.csv)")
    print(f"[eval_c16] {len(train_items)} training slides, {len(test_items)} test slides")

    arch = args.extractor or ("simple_cnn" if args.synthetic else "dinov2")
    extractor = PatchFeatureExtractor(arch=arch, device=device)
    weights_loaded = False
    if args.vit_weights is not None:
        extractor.load_npz_weights(str(args.vit_weights))
        weights_loaded = True
        print(f"[eval_c16] loaded converted ViT weights: {args.vit_weights}")
    else:
        print("[eval_c16] WARNING: no --vit-weights; the backbone is RANDOM-INIT — "
              "the resulting AUC does NOT discharge the parity target.")

    if args.ab_window and args.window is None:
        ap.error("--ab-window requires --window")
    processor = SlideProcessor(patch_size=patch_size, max_patches=max_patches,
                               tissue_threshold=tissue_threshold, device=device)
    if args.config == "large":  # configs/dgdm_large.yaml geometry
        hidden, heads, steps = (768, 512, 256, 128), 16, 20
    else:                       # configs/dgdm_base.yaml geometry
        hidden, heads, steps = (512, 256, 128), 8, 10
    if args.hidden is not None:
        hidden = tuple(int(h) for h in args.hidden.split(","))

    spec = GateSpec(
        train_items=train_items, test_items=test_items, num_classes=2,
        extractor=extractor, arch=arch, weights_loaded=weights_loaded,
        processor=processor, hidden=hidden, heads=heads, steps=steps,
        bucket=bucket, max_patches=max_patches, patch_size=patch_size,
        pretrain_epochs=pretrain_epochs, finetune_epochs=finetune_epochs,
        dataset_name=(("camelyon16-synthetic-hard" if args.hard
                       else "camelyon16-synthetic-standin") if args.synthetic
                      else "camelyon16"),
        device=device, reference_target=REFERENCE_TARGETS[args.config],
        default_arch="simple_cnn" if args.synthetic else "dinov2", t_start=t_start,
        render_missing=lambda paths: render_slides({p: jobs[p] for p in paths if p in jobs}))
    return run_gate(args, ap, spec)


if __name__ == "__main__":
    main()
