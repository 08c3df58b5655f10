"""PANDA prostate ISUP-grading accuracy evaluation, staged end to end, on the
port (counterpart of the repository's ``scripts/eval_panda.py``).

The reference's third accuracy row is PANDA AUC 0.928 (DGDM-Base) / 0.941
(DGDM-Large). Reproducing it needs converted pretrained DINOv2 weights
(``convert_timm_vit``) and the PANDA slides and ISUP labels. Beyond the
AUC this reports quadratic-weighted kappa with the expected-grade decode
(``evaluation.metrics.quadratic_weighted_kappa``)::

    <root>/slides/<slide_id>.(svs|tif|tiff)
    <root>/labels.csv            # slide_id,isup_grade rows, grade in 0..5

    python -m dgdm_histopath_torch.scripts.eval_panda --data-root /data/panda \
        --vit-weights dinov2_b14.npz --out results/panda

``--synthetic`` runs the same pipeline on stand-ins where each ISUP grade
carries a distinct nuclei density (a geometric ~2x ladder)::

    python -m dgdm_histopath_torch.scripts.eval_panda --synthetic --out panda

It runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve
from .gate_harness import device_name, slide_to_graph

N_GRADES = 6  # ISUP 0-5
# geometric ~2x density ladder; grade 0 (benign) sparsest
GRADE_DENSITY = [0.0005, 0.001, 0.002, 0.004, 0.008, 0.016]
REFERENCE_TARGET = {  # the reference README's accuracy table
    "base": {"auc": 0.928}, "large": {"auc": 0.941}}


def discover_panda(root: Path):
    """(slide_path, isup_grade) pairs from <root>/slides + labels.csv."""
    labels = {}
    csv_path = root / "labels.csv"
    if csv_path.exists():
        with open(csv_path) as f:
            for row in csv.reader(f):
                if len(row) >= 2 and row[1].strip().isdigit():
                    g = int(row[1].strip())
                    if 0 <= g < N_GRADES:
                        labels[row[0].strip()] = g
    items = []
    for p in sorted((root / "slides").glob("*")):
        if p.suffix.lower() in (".svs", ".tif", ".tiff") and p.stem in labels:
            items.append((p, labels[p.stem]))
    return items


def generate_synthetic_panda(root: Path, n_train_per_grade: int = 6,
                             n_test_per_grade: int = 3,
                             size: int = 2048) -> None:
    """Stand-in slides in the PANDA layout; one density signature per ISUP
    grade. Test slides are listed in ``test_split.txt``."""
    from ..preprocessing.synthetic import write_synthetic_tiff
    slides = root / "slides"
    slides.mkdir(parents=True, exist_ok=True)
    rows, test_ids = [], []
    seed = 0
    for grade in range(N_GRADES):
        for i in range(n_train_per_grade + n_test_per_grade):
            seed += 1
            sid = f"isup{grade}_{i:03d}"
            p = slides / f"{sid}.tiff"
            if not p.exists():
                write_synthetic_tiff(p, width=size, height=size,
                                     num_levels=3, seed=seed,
                                     nuclei_density=GRADE_DENSITY[grade])
            rows.append((sid, str(grade)))
            if i >= n_train_per_grade:
                test_ids.append(sid)
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    (root / "test_split.txt").write_text("\n".join(test_ids) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="eval_panda", description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", type=Path, default=None)
    ap.add_argument("--vit-weights", type=Path, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", type=Path, default=Path("panda_eval"))
    ap.add_argument("--config", choices=("base", "large"), default="base")
    ap.add_argument("--bucket", type=int, default=None)
    ap.add_argument("--max-patches", type=int, default=None)
    ap.add_argument("--patch-size", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--test-frac", type=float, default=0.25)
    ap.add_argument("--pretrain-epochs", type=int, default=None)
    ap.add_argument("--finetune-epochs", type=int, default=None)
    ap.add_argument("--extractor", default=None)
    ap.add_argument("--window", type=int, default=None,
                    help="windowed scaling config (spatial_window + "
                         "graph_window = W, knn_window-built graphs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve(ap, args.cpu)

    from ..evaluation.metrics import (
        compute_classification_metrics, expected_grade_decode, quadratic_weighted_kappa,
    )
    from ..models import DGDMModel
    from ..models.vit import PatchFeatureExtractor
    from ..nn.layers import init_parameters
    from ..ops.graph import batch_graphs
    from ..preprocessing import SlideProcessor, TissueGraphBuilder
    from ..training import DGDMTrainer, TrainerConfig

    t_start = time.time()
    args.out.mkdir(parents=True, exist_ok=True)

    if args.synthetic:
        data_root = args.out / "synthetic_data"
        print(f"[eval_panda] generating synthetic stand-ins at {data_root}")
        generate_synthetic_panda(data_root)
        bucket = args.bucket or 256
        max_patches = args.max_patches or 256
        patch_size = args.patch_size or 64
        tissue_threshold = 0.3
        pretrain_epochs = 1 if args.pretrain_epochs is None else args.pretrain_epochs
        finetune_epochs = 40 if args.finetune_epochs is None else args.finetune_epochs
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

    items = discover_panda(data_root)
    if not items:
        sys.exit(f"no labeled slides under {data_root} (expected slides/ + "
                 f"labels.csv with ISUP grades 0..{N_GRADES - 1})")
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
    print(f"[eval_panda] {len(train_items)} train / {len(test_items)} test "
          f"slides across {N_GRADES} ISUP grades")

    arch = args.extractor or ("simple_cnn" if args.synthetic else "dinov2")
    extractor = PatchFeatureExtractor(arch=arch, device=device)
    weights_loaded = False
    if args.vit_weights is not None:
        extractor.load_npz_weights(str(args.vit_weights))
        weights_loaded = True
    else:
        print("[eval_panda] WARNING: RANDOM-INIT backbone — the resulting "
              "metrics do NOT discharge the parity target.")

    processor = SlideProcessor(patch_size=patch_size,
                               max_patches=max_patches,
                               tissue_threshold=tissue_threshold, device=device)
    builder = TissueGraphBuilder(extractor=extractor, node_buckets=(bucket,),
                                 spatial_sort=args.window is not None,
                                 knn_window=args.window, device=device)
    cache_dir = args.out / "graph_cache"
    cache_dir.mkdir(parents=True, exist_ok=True)
    sort_tag = f"_w{args.window}" if args.window else ""
    t0 = time.time()
    train_graphs = [slide_to_graph(p, y, processor, builder, cache_dir,
                                   bucket, sort_tag) for p, y in train_items]
    test_graphs = [slide_to_graph(p, y, processor, builder, cache_dir,
                                  bucket, sort_tag) for p, y in test_items]
    prep_s = time.time() - t0

    if args.config == "large":
        hidden, heads, steps = (768, 512, 256, 128), 16, 20
    else:
        hidden, heads, steps = (512, 256, 128), 8, 10
    extra = ({"spatial_window": args.window, "graph_window": args.window}
             if args.window else {})
    model = DGDMModel(node_features=extractor.feature_dim,
                      hidden_dims=hidden, attention_heads=heads,
                      num_diffusion_steps=steps, graph_layers=4,
                      num_classes=N_GRADES, pooling="attention", **extra)
    init_parameters(model, torch.Generator().manual_seed(args.seed))

    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(train_graphs))
    n_val = max(1, len(order) // 5)
    val_idx, tr_idx = order[:n_val], order[n_val:]

    def as_batches(idxs):
        return [batch_graphs([train_graphs[i] for i in idxs[j:j + args.batch_size]])
                for j in range(0, len(idxs), args.batch_size)]

    train_batches, val_batches = as_batches(tr_idx), as_batches(val_idx)
    trainer = DGDMTrainer(model, TrainerConfig(
        learning_rate=1e-4 if weights_loaded else 1e-3,
        warmup_steps=min(100, len(train_batches)),
        max_epochs=pretrain_epochs + finetune_epochs,
        pretrain_epochs=pretrain_epochs,
        steps_per_epoch=len(train_batches)), device=device)
    trainer.init_state(args.seed, train_batches[0])
    print(f"[eval_panda] finetuning {args.config}: {pretrain_epochs} pretrain "
          f"+ {finetune_epochs} finetune epochs x {len(train_batches)} steps")
    fit = trainer.fit(train_batches, val_batches,
                      max_epochs=pretrain_epochs + finetune_epochs,
                      early_stopping_patience=max(10, finetune_epochs // 3))

    probs, labels = [], []
    for j in range(0, len(test_graphs), args.batch_size):
        chunk = test_graphs[j:j + args.batch_size]
        out = trainer.predict_step(batch_graphs(chunk),
                                   return_attention=False)
        logits = out["classification_logits"].double().cpu().numpy()
        p = np.exp(logits - logits.max(-1, keepdims=True))
        probs.append(p / p.sum(-1, keepdims=True))
        labels.extend(int(g.y) for g in chunk)
    labels = np.asarray(labels)
    probs = np.concatenate(probs, axis=0)
    metrics = compute_classification_metrics(labels, probs)
    preds_argmax = probs.argmax(axis=1)
    preds_expected = expected_grade_decode(probs)
    qwk_argmax = quadratic_weighted_kappa(labels, preds_argmax, N_GRADES)
    qwk_expected = quadratic_weighted_kappa(labels, preds_expected, N_GRADES)

    report = {
        "dataset": "panda-synthetic-standin" if args.synthetic else "panda",
        "task": "ISUP grading (6-class ordinal)",
        "config": args.config, "extractor": arch,
        "backbone_pretrained": weights_loaded,
        "window": args.window,
        "n_train": len(train_items), "n_test": len(test_items),
        "bucket": bucket,
        "auc_macro_ovr": metrics.get("auc"),
        "f1_macro": metrics.get("f1"),
        "accuracy": metrics.get("accuracy"),
        "qwk_argmax": round(qwk_argmax, 4),
        "qwk_expected_decode": round(qwk_expected, 4),
        "confusion_matrix": metrics.get("confusion_matrix"),
        "reference_target": REFERENCE_TARGET[args.config],
        "parity_valid": weights_loaded and not args.synthetic,
        "preprocess_s_per_slide": round(prep_s / max(len(items), 1), 2),
        "best_val_loss": fit["best_val_loss"],
        "wall_s": round(time.time() - t_start, 1),
        "device": device_name(device),
    }
    (args.out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    if not report["parity_valid"]:
        print("[eval_panda] NOTE: does NOT establish reference parity "
              "(synthetic and/or random-init backbone).")
    return report


if __name__ == "__main__":
    main()
