"""``dgdm-predict`` on the port: inference over graph files, slides or a
directory of either, to one JSON per input and/or ``predictions.csv``
(counterpart of the JAX package's ``cli/predict.py``; the same flags, plus
``--device``).

    python -m dgdm_histopath_torch.cli.predict --model out/final_model.npz \\
        --input graphs/ --output-dir preds/ --format both

It runs on the card unless ``--device cpu`` is given. ``--save-heatmaps``
writes ``<slide_id>_summary.png`` and ``<slide_id>_summary.html`` beside each
result that has attention weights (matplotlib needed for the PNG).
``--quant int8`` predicts with w8a8 int8 inference (``models/quantized.py``).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path

import numpy as np

from ..utils.device import resolve_device
from ..utils.logging import get_logger, setup_logging

logger = get_logger("cli")

SLIDE_EXTS = (".svs", ".tiff", ".tif", ".ndpi", ".mrxs", ".wsi")
GRAPH_EXTS = (".npz", ".h5", ".hdf5")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgdm-predict")
    p.add_argument("--model", required=True, help="model bundle (.npz)")
    p.add_argument("--input", required=True, help="slide/graph file or directory")
    p.add_argument("--output-dir", default="./predictions")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to predict (default: the card)")
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--magnification", type=float, default=20.0)
    p.add_argument("--max-patches", type=int, default=1000)
    p.add_argument("--feature-extractor", default="dinov2")
    p.add_argument("--tissue-threshold", type=float, default=0.8)
    p.add_argument("--no-stain-normalize", action="store_true")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="w8a8 int8 inference (int8 Dense layers)")
    p.add_argument("--save-heatmaps", action="store_true",
                   help="write a PNG and an interactive HTML summary per input")
    p.add_argument("--format", choices=["json", "csv", "both"], default="json")
    p.add_argument("--class-names", type=str, default=None,
                   help="comma-separated class names")
    p.add_argument("--log-level", default="INFO")
    return p


def _serializable(result: dict) -> dict:
    out = {}
    for k, v in result.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(f"{exc} (--device cpu)")
    from ..data.graph_io import load_graph
    from ..evaluation import AttentionVisualizer, DGDMPredictor
    from ..preprocessing.slide_io import _advise_readahead

    predictor = DGDMPredictor(
        model_path=args.model, device=device, patch_size=args.patch_size,
        magnification=args.magnification, max_patches=args.max_patches,
        feature_extractor=args.feature_extractor, tissue_threshold=args.tissue_threshold,
        stain_normalize=not args.no_stain_normalize, quant=args.quant)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    src = Path(args.input)
    if src.is_dir():
        inputs = sorted(p for p in src.rglob("*")
                        if p.suffix.lower() in SLIDE_EXTS + GRAPH_EXTS)
    else:
        inputs = [src]
    if not inputs:
        logger.error("no inputs found under %s", src)
        return 1

    viz = AttentionVisualizer() if args.save_heatmaps else None
    class_names = args.class_names.split(",") if args.class_names else None
    rows = []
    failed = 0
    try:
        for i, path in enumerate(inputs):
            if i + 1 < len(inputs):
                # the next input's file streams into the page cache while
                # this one runs
                _advise_readahead(inputs[i + 1])
            try:
                if path.suffix.lower() in GRAPH_EXTS:
                    result = predictor.predict_graph(load_graph(path))
                    result["slide_id"] = path.stem
                else:
                    result = predictor.predict_slide(path)
                rows.append(result)
                if args.format in ("json", "both"):
                    (out_dir / f"{result['slide_id']}.json").write_text(
                        json.dumps(_serializable(result), indent=2))
                if viz is not None and "attention_weights" in result:
                    stem = f"{result['slide_id']}_summary"
                    viz.prediction_summary(result, class_names=class_names,
                                           save_path=out_dir / f"{stem}.png")
                    viz.prediction_summary_interactive(result, class_names=class_names,
                                                       save_path=out_dir / f"{stem}.html")
                logger.info("%s -> class=%s conf=%.3f", result["slide_id"],
                            result.get("predicted_class"), result.get("confidence", 0))
            except Exception as exc:  # noqa: BLE001 - one bad input does not stop the run
                logger.error("%s failed: %s", path, exc)
                failed += 1
    finally:
        predictor.close()

    if rows and args.format in ("csv", "both"):
        with open(out_dir / "predictions.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["slide_id", "predicted_class", "confidence", "entropy"])
            for r in rows:
                writer.writerow([r.get("slide_id"), r.get("predicted_class"),
                                 r.get("confidence"), r.get("uncertainty", {}).get("entropy")])
    logger.info("predicted %d inputs (%d failed) -> %s", len(rows), failed, out_dir)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
