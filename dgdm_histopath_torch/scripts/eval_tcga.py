"""TCGA-BRCA molecular-subtyping accuracy evaluation, staged end to end, on
the port (counterpart of the repository's ``scripts/eval_tcga.py``).

The reference's second accuracy headline is TCGA-BRCA 4-subtype
classification AUC 0.943 / F1 0.891 for DGDM-Base (subtypes LumA / LumB /
Her2 / Basal). Reproducing it needs converted pretrained DINOv2 weights
(``convert_timm_vit``) and the TCGA-BRCA slides and subtype labels::

    <root>/slides/<slide_id>.(svs|tif|tiff)
    <root>/labels.csv            # slide_id,label rows, label in SUBTYPES

    python -m dgdm_histopath_torch.scripts.eval_tcga --data-root /data/tcga_brca \
        --vit-weights dinov2_b14.npz --out results/tcga

``--synthetic`` runs the same pipeline on stand-ins where each subtype
carries a distinct global nuclei density (it saturates: a smoke loop).
``--synthetic --hard`` is the calibrated 4-subtype hard task: every slide
carries one focus whose density against the slide's own baseline falls in
its subtype's band (``preprocessing.synthetic.HARD_MULTICLASS_BANDS``,
ordinal), under baseline, stain and scanner jitter and train label noise,
through the shared multi-seed harness (``gate_harness``)::

    python -m dgdm_histopath_torch.scripts.eval_tcga --synthetic --hard \
        --out tcga_hard --train-seed 0,1,2 --window 32 --ab-window --ab-int8

Slides are rendered on the host with the JAX package's pixels, only where a
graph is not cached; the rest runs on the card unless ``--cpu`` is given.
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
from .eval_camelyon16 import _write_or_defer

SUBTYPES = ["LumA", "LumB", "Her2", "Basal"]
# legacy easy stand-in: adjacent-class GLOBAL density contrast ~2x
SUBTYPE_DENSITY = {"LumA": 0.0008, "LumB": 0.0018, "Her2": 0.0038,
                   "Basal": 0.008}
REFERENCE_TARGET = {"auc": 0.943, "f1": 0.891}  # the reference README's table


def discover_tcga(root: Path, listed: Iterable[Path] = ()):
    """(slide_path, class_index) pairs from <root>/slides + labels.csv;
    ``listed`` slides count as present whether or not their file exists."""
    labels = {}
    csv_path = root / "labels.csv"
    if csv_path.exists():
        with open(csv_path) as f:
            for row in csv.reader(f):
                if len(row) >= 2 and row[1].strip() in SUBTYPES:
                    labels[row[0].strip()] = SUBTYPES.index(row[1].strip())
    items = []
    slides = root / "slides"
    for p in sorted(set(slides.glob("*")) | {p for p in listed if p.parent == slides}):
        if p.suffix.lower() in (".svs", ".tif", ".tiff") and p.stem in labels:
            items.append((p, labels[p.stem]))
    return items


def generate_synthetic_tcga(root: Path, n_train_per_class: int = 8,
                            n_test_per_class: int = 4, size: int = 2048,
                            jobs: Optional[Dict[Path, dict]] = None) -> None:
    """Legacy easy stand-in (global density signature per subtype;
    saturates — kept as the smoke loop). Test slides are listed in
    ``test_split.txt``. ``jobs``, where given, receives the slides to write
    ({path: kwargs}) instead of their being written here."""
    slides = root / "slides"
    slides.mkdir(parents=True, exist_ok=True)
    rows, test_ids = [], []
    seed = 0
    for ci, name in enumerate(SUBTYPES):
        for i in range(n_train_per_class + n_test_per_class):
            seed += 1
            sid = f"{name.lower()}_{i:03d}"
            p = slides / f"{sid}.tiff"
            _write_or_defer(p, dict(width=size, height=size, num_levels=3, seed=seed,
                                    nuclei_density=SUBTYPE_DENSITY[name]), jobs)
            rows.append((sid, name))
            if i >= n_train_per_class:
                test_ids.append(sid)
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    (root / "test_split.txt").write_text("\n".join(test_ids) + "\n")


def generate_synthetic_tcga_hard(root: Path, n_train_per_class: int = 24,
                                 n_test_per_class: int = 32,
                                 size: int = 1024, seed: int = 0,
                                 label_noise: float = 0.05,
                                 jobs: Optional[Dict[Path, dict]] = None) -> dict:
    """Calibrated hard 4-subtype stand-in.

    Same nuisance structure as the binary hard task (focal signal vs the
    slide's OWN jittered baseline, stain/scanner jitter, train label noise
    — ``generate_synthetic_camelyon16_hard`` docstring) but the label is
    ORDINAL: class k's focal contrast is drawn from
    ``HARD_MULTICLASS_BANDS[k]``. Every slide has a focus, so "is there a
    focus" is non-diagnostic — only its relative contrast is, and adjacent
    bands are close enough that the macro OVR AUC stays off the ceiling.
    Label noise files a training slide under a uniformly-random OTHER
    subtype (test labels stay clean).

    Returns the generation manifest (written to ``root/manifest.json``);
    ``jobs`` as in :func:`generate_synthetic_tcga`.
    """
    from ..preprocessing.synthetic import HARD_MULTICLASS_BANDS, sample_hard_slide_params
    slides = root / "slides"
    slides.mkdir(parents=True, exist_ok=True)
    rows, test_ids, manifest = [], [], []
    rs_noise = np.random.RandomState(seed + 777)
    idx = 0
    for split, n in (("training", n_train_per_class),
                     ("testing", n_test_per_class)):
        for ci, name in enumerate(SUBTYPES):
            for i in range(n):
                idx += 1
                rs = np.random.RandomState(seed * 100003 + idx)
                params = sample_hard_slide_params(
                    rs, tumor=True, size=size, seed=seed + idx,
                    lesion_contrast=HARD_MULTICLASS_BANDS[ci])
                params["num_levels"] = 3
                filed = ci
                if split == "training" and rs_noise.rand() < label_noise:
                    others = [c for c in range(len(SUBTYPES)) if c != ci]
                    filed = int(rs_noise.choice(others))
                sid = f"{name.lower()}_{split[:2]}_{idx:04d}"
                p = slides / f"{sid}.tiff"
                _write_or_defer(p, params, jobs)
                rows.append((sid, SUBTYPES[filed]))
                if split == "testing":
                    test_ids.append(sid)
                manifest.append({
                    "slide": sid, "split": split, "true_class": ci,
                    "filed_class": filed,
                    "baseline_density": round(params["nuclei_density"], 6),
                    "focal_density": round(params["focal_density"], 6),
                    "focal_frac": round(params["focal_frac"], 4)})
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    (root / "test_split.txt").write_text("\n".join(test_ids) + "\n")
    man = {"task": "tcga-hard-standin", "seed": seed, "size": size,
           "subtypes": SUBTYPES,
           "bands": [list(b) for b in HARD_MULTICLASS_BANDS],
           "n_train": len(SUBTYPES) * n_train_per_class,
           "n_test": len(SUBTYPES) * n_test_per_class,
           "label_noise": label_noise, "slides": manifest}
    (root / "manifest.json").write_text(json.dumps(man, indent=1))
    return man


def main(argv=None):
    ap = argparse.ArgumentParser(prog="eval_tcga",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", type=Path, default=None)
    ap.add_argument("--vit-weights", type=Path, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--hard", action="store_true",
                    help="with --synthetic: the CALIBRATED 4-subtype hard "
                         "stand-in (focal-contrast bands vs per-slide "
                         "baseline; see generate_synthetic_tcga_hard). "
                         "Implies the calibrated training recipe defaults "
                         "(stats extractor, per-slide norm, 256,128,64 "
                         "hidden, dropout 0.2, wd 1e-3, ftlr 1.0, "
                         "selection final, 4+40 epochs) — all overridable")
    ap.add_argument("--out", type=Path, default=Path("tcga_eval"))
    ap.add_argument("--report-name", default="report.json")
    ap.add_argument("--config", choices=("base", "large"), default="base")
    ap.add_argument("--bucket", type=int, default=None)
    ap.add_argument("--max-patches", type=int, default=None)
    ap.add_argument("--patch-size", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--n-train-per-class", type=int, default=None,
                    help="synthetic only (default: 8 easy / 24 hard)")
    ap.add_argument("--n-test-per-class", type=int, default=None,
                    help="synthetic only (default: 4 easy / 32 hard)")
    ap.add_argument("--slide-size", type=int, default=None,
                    help="synthetic slide edge in px (default 2048 easy / "
                         "1024 hard; the BINDING window gate uses 2048px "
                         "with --patch-size 32 --bucket 1024 so ~450 real "
                         "nodes span 14+ Morton blocks)")
    ap.add_argument("--test-frac", type=float, default=0.25,
                    help="real-data holdout fraction (synthetic uses the "
                         "generated test_split.txt)")
    ap.add_argument("--pretrain-epochs", type=int, default=None)
    ap.add_argument("--finetune-epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--extractor", default=None)
    ap.add_argument("--per-slide-norm", action="store_true", default=None)
    ap.add_argument("--hidden", default=None,
                    help="comma-separated hidden dims override")
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--weight-decay", type=float, default=None)
    ap.add_argument("--finetune-lr-factor", type=float, default=None)
    ap.add_argument("--selection", choices=("val_loss", "final"),
                    default=None,
                    help="default: val_loss (reference semantics) / final "
                         "under --hard (see eval_camelyon16 --selection)")
    ap.add_argument("--window", type=str, default=None,
                    help="windowed scaling config(s), comma list — see "
                         "eval_camelyon16 --window")
    ap.add_argument("--ab-window", action="store_true")
    ap.add_argument("--ab-int8", action="store_true")
    ap.add_argument("--ab-pretrain", action="store_true")
    ap.add_argument("--moe-experts", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-seed", type=str, default=None,
                    help="training-seed replicate list — see "
                         "eval_camelyon16 --train-seed")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--prep-only", action="store_true",
                    help="build the graph caches then exit (see "
                         "eval_camelyon16.py --prep-only)")
    args = ap.parse_args(argv)
    device = resolve(ap, args.cpu)

    from ..models.vit import PatchFeatureExtractor
    from ..preprocessing import SlideProcessor
    from .gate_harness import GateSpec, render_slides, run_gate

    t_start = time.time()
    args.out.mkdir(parents=True, exist_ok=True)

    # --hard implies the calibrated recipe (every default below is
    # load-bearing on the binary hard gate; the 4-class task shares its
    # signal and nuisance structure)
    hard = args.synthetic and args.hard
    if args.n_train_per_class is None:
        args.n_train_per_class = 24 if hard else 8
    if args.n_test_per_class is None:
        args.n_test_per_class = 32 if hard else 4
    if hard:
        if args.extractor is None:
            args.extractor = "stats"
        if args.per_slide_norm is None:
            args.per_slide_norm = True
        if args.hidden is None:
            args.hidden = "256,128,64"
        if args.dropout is None:
            args.dropout = 0.2
        if args.weight_decay is None:
            args.weight_decay = 1e-3
        if args.finetune_lr_factor is None:
            args.finetune_lr_factor = 1.0
        if args.selection is None:
            args.selection = "final"
        if args.lr is None:
            args.lr = 1e-3
    if args.per_slide_norm is None:
        args.per_slide_norm = False
    if args.selection is None:
        args.selection = "val_loss"

    jobs: Dict[Path, dict] = {}
    if args.synthetic:
        data_root = args.out / "synthetic_data"
        print(f"[eval_tcga] synthetic stand-ins at {data_root}")
        if hard:
            generate_synthetic_tcga_hard(
                data_root, n_train_per_class=args.n_train_per_class,
                n_test_per_class=args.n_test_per_class, seed=args.seed,
                size=args.slide_size or 1024, jobs=jobs)
        else:
            generate_synthetic_tcga(data_root,
                                    n_train_per_class=args.n_train_per_class,
                                    n_test_per_class=args.n_test_per_class,
                                    size=args.slide_size or 2048, jobs=jobs)
        bucket = args.bucket or 256
        max_patches = args.max_patches or 256
        patch_size = args.patch_size or 64
        tissue_threshold = 0.3
        pretrain_epochs = ((4 if hard else 1) if args.pretrain_epochs is None
                           else args.pretrain_epochs)
        finetune_epochs = (40 if args.finetune_epochs is None
                           else args.finetune_epochs)
    else:
        if args.data_root is None:
            ap.error("--data-root required without --synthetic")
        data_root = args.data_root
        bucket = args.bucket or (2048 if args.config == "large" else 1024)
        max_patches = args.max_patches or (2000 if args.config == "large"
                                           else 1000)
        patch_size = args.patch_size or 256
        tissue_threshold = 0.5
        pretrain_epochs = (50 if args.pretrain_epochs is None
                           else args.pretrain_epochs)
        finetune_epochs = (50 if args.finetune_epochs is None
                           else args.finetune_epochs)

    items = discover_tcga(data_root, listed=jobs)
    if not items:
        sys.exit(f"no labeled slides under {data_root} (expected slides/ + "
                 f"labels.csv with labels in {SUBTYPES})")
    split_file = data_root / "test_split.txt"
    if split_file.exists():
        test_ids = set(split_file.read_text().split())
        train_items = [(p, y) for p, y in items if p.stem not in test_ids]
        test_items = [(p, y) for p, y in items if p.stem in test_ids]
    else:
        rng = np.random.RandomState(args.seed)
        order = rng.permutation(len(items))
        n_test = max(1, int(round(args.test_frac * len(items))))
        test_items = [items[i] for i in order[:n_test]]
        train_items = [items[i] for i in order[n_test:]]
    print(f"[eval_tcga] {len(train_items)} train / {len(test_items)} test "
          f"slides across {len(SUBTYPES)} subtypes")

    arch = args.extractor or ("simple_cnn" if args.synthetic else "dinov2")
    extractor = PatchFeatureExtractor(arch=arch, device=device)
    weights_loaded = False
    if args.vit_weights is not None:
        extractor.load_npz_weights(str(args.vit_weights))
        weights_loaded = True
    else:
        print("[eval_tcga] WARNING: RANDOM-INIT backbone — the resulting "
              "AUC does NOT discharge the parity target.")

    if args.ab_window and args.window is None:
        ap.error("--ab-window requires --window")
    processor = SlideProcessor(patch_size=patch_size,
                               max_patches=max_patches,
                               tissue_threshold=tissue_threshold, device=device)

    if args.config == "large":
        hidden, heads, steps = (768, 512, 256, 128), 16, 20
    else:
        hidden, heads, steps = (512, 256, 128), 8, 10
    if args.hidden is not None:
        hidden = tuple(int(h) for h in args.hidden.split(","))

    spec = GateSpec(
        train_items=train_items, test_items=test_items,
        num_classes=len(SUBTYPES),
        extractor=extractor, arch=arch, weights_loaded=weights_loaded,
        processor=processor, hidden=hidden, heads=heads, steps=steps,
        bucket=bucket, max_patches=max_patches, patch_size=patch_size,
        pretrain_epochs=pretrain_epochs, finetune_epochs=finetune_epochs,
        dataset_name=(("tcga-brca-synthetic-hard" if hard
                       else "tcga-brca-synthetic-standin") if args.synthetic
                      else "tcga-brca"),
        reference_target=REFERENCE_TARGET,
        default_arch="simple_cnn" if args.synthetic else "dinov2",
        report_extra={"task": "4-subtype classification",
                      "subtypes": SUBTYPES,
                      "auc_metric": "macro_ovr"},
        device=device, t_start=t_start,
        render_missing=lambda paths: render_slides({p: jobs[p] for p in paths if p in jobs}))
    return run_gate(args, ap, spec)


if __name__ == "__main__":
    main()
