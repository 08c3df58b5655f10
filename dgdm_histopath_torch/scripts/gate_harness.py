"""Shared multi-seed A/B gate harness for the staged accuracy evaluations
(counterpart of the repository's ``scripts/gate_harness.py``).

Both calibrated hard gates (CAMELYON16 binary, ``eval_camelyon16 --hard``,
and TCGA-BRCA 4-subtype, ``eval_tcga --hard``) run the same protocol:

  variants (dense / window{W} / moe{E} / scratch, + int8 rider on dense)
    x training seeds (``--train-seed 0,1,...``: the data seed stays pinned,
      so every replicate shares the same test set and the arms pool with
      ``evaluation.metrics.pooled_paired_bootstrap_delta``)

with per-arm crash-resume (``variant_{tag}_s{seed}[t{tseed}].npz`` holding
the test probabilities, labels, metrics and the arm's config fingerprint)
and per-seed reports, in the JAX package's keys, so one
``aggregate_hard_seeds`` reads either package's arms. All seeds run in one
process; each arm's model and trainer are built once and re-initialized per
seed (parameters drawn from the train seed, ``init_state(tseed, example)``).

The fingerprint carries ``"backend": "torch"``: a run resumed into an
``--out`` that holds the JAX package's arm of the same tag (whose
fingerprint has no backend, or which has none at all) is refused by the
mismatch error instead of pooling two frameworks' seeds.

Binary tasks store 1-d tumor-probability vectors; multi-class tasks store
the full ``[N, C]`` probability matrix and pool with macro one-vs-rest AUC.
Graphs are read from and written to ``--out/graph_cache`` as
``{stem}_b{bucket}{tag}.npz``; a slide whose graph is cached is never read
(its file need not exist).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph_io import load_graph, save_graph
from ..ops.graph import PaddedGraph

BACKEND = "torch"


def slide_to_graph(path: Path, label: int, processor, builder, cache_dir: Path,
                   bucket: int, sort_tag: str = "") -> PaddedGraph:
    """Preprocess one slide into a cached PaddedGraph (CPU tensors)."""
    cache = cache_dir / f"{path.stem}_b{bucket}{sort_tag}.npz"
    if cache.exists():
        g = load_graph(cache)
    else:
        slide_data = processor.process_slide(str(path), slide_id=path.stem)
        g = builder.build_graph(slide_data, bucket=bucket)
        save_graph(g, cache)
        g = g.to("cpu")
    return g.replace(y=torch.tensor(label, dtype=torch.int32))


@dataclass
class GateSpec:
    """Task-specific inputs to :func:`run_gate` (everything the shared
    variant x seed machinery does not own)."""
    train_items: Sequence[Tuple[Path, int]]
    test_items: Sequence[Tuple[Path, int]]
    num_classes: int
    extractor: Any                  # PatchFeatureExtractor
    arch: str
    weights_loaded: bool
    processor: Any                  # SlideProcessor
    hidden: Tuple[int, ...]
    heads: int
    steps: int
    bucket: int
    max_patches: int
    patch_size: int
    pretrain_epochs: int
    finetune_epochs: int
    dataset_name: str
    device: Any = "cuda"
    reference_target: Optional[Dict[str, Any]] = None
    default_arch: str = "simple_cnn"   # cache tags mark non-default arches
    report_extra: Dict[str, Any] = field(default_factory=dict)
    t_start: float = field(default_factory=time.time)
    # renders a slide file that is not on disk (a synthetic slide whose
    # generation was deferred), called for the cache misses only
    render_missing: Optional[Callable[[List[Path]], None]] = None


def _render_one(job: Tuple[Path, dict]) -> Path:
    from ..preprocessing.synthetic import write_synthetic_tiff
    path, params = job
    return write_synthetic_tiff(path, **params)


# level-0 pixels one spawned renderer must have to earn its start-up: the
# pixels this process renders while a spawned worker starts (it imports torch
# and the port before its first slide). chip_smoke.py --gates-only measures
# both; on an H100's host, 0.69 s a megapixel and 11.6 s: 15.9 Mpx (PERF.md).
PIXELS_PER_WORKER = 1 << 24


def render_slides(jobs: Dict[Path, dict]) -> None:
    """Write the synthetic slides ``jobs`` ({path: ``write_synthetic_tiff``
    kwargs}) on the host, with the JAX package's pixels (the numpy
    renderer), in one spawned process per ``PIXELS_PER_WORKER`` level-0
    pixels, at most one per core; fewer than two workers' pixels render in
    this process."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor
    items = sorted(jobs.items(), key=lambda kv: str(kv[0]))
    pixels = sum(kw["width"] * kw["height"] for _, kw in items)
    workers = min(os.cpu_count() or 1, pixels // PIXELS_PER_WORKER)
    if workers <= 1:
        for item in items:
            _render_one(item)
        return
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        list(pool.map(_render_one, items, chunksize=max(1, len(items) // (4 * workers))))


def metric_fn_for(num_classes: int):
    """Scalar metric over (labels, stored scores): binary AUC on 1-d tumor
    probs, macro OVR AUC on [N, C] prob matrices."""
    from ..evaluation.metrics import _roc_auc, macro_ovr_auc
    return _roc_auc if num_classes == 2 else macro_ovr_auc


def build_variants(args, ap) -> List[Tuple[str, dict, Optional[int], Optional[int]]]:
    """(tag, model kwargs, graph-build knn_window, pretrain override) list
    from the shared A/B flags. The windowed config pairs the banded model
    with band-built graphs, so its banded compute is exact by construction."""
    windows = ([int(w) for w in str(args.window).split(",")]
               if args.window is not None else [])
    variants: List[Tuple[str, dict, Optional[int], Optional[int]]] = []
    if not windows or args.ab_window:
        variants.append(("dense", {}, None, None))
    for w in windows:
        variants.append((f"window{w}", {"spatial_window": w, "graph_window": w}, w, None))
    if args.moe_experts:
        variants.append((f"moe{args.moe_experts}",
                         {"moe_experts": args.moe_experts}, None, None))
    if args.ab_pretrain:
        # transfer gate: same finetune budget, no SSL pretraining phase
        variants.append(("scratch", {}, None, 0))
    if args.ab_int8 and not any(t == "dense" for t, _, _, _ in variants):
        ap.error("--ab-int8 pairs int8 inference against the dense arm, but "
                 "no dense arm is scheduled (--window without --ab-window); "
                 "add --ab-window or drop --window")
    return variants


def cache_tag(spec: GateSpec, knn_window: Optional[int], per_slide_norm: bool) -> str:
    """The graph-cache suffix of one graph-build config (after ``_b{bucket}``)."""
    tag = f"_w{knn_window}" if knn_window else ""
    if spec.arch != spec.default_arch:      # distinct features
        tag += "_" + spec.arch.replace("+", "-")
    if per_slide_norm:
        tag += "_psn"
    if spec.patch_size != 64:               # distinct patch grid (64: synthetic default)
        tag += f"_p{spec.patch_size}"
    if spec.max_patches != spec.bucket:     # distinct subsample cap
        tag += f"_mp{spec.max_patches}"
    return tag


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def predict_probs(model, graphs: Sequence[PaddedGraph], batch_size: int,
                  int8: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Softmax probabilities [N, C] (f64, from the logits) and labels of
    ``graphs``, ``batch_size`` at a time (the last batch padded by
    repeating its last graph), through ``model`` on its device in eval mode,
    or through the int8 Dense path with ``int8``."""
    from ..models.quantized import int8_apply
    from ..ops.graph import batch_graphs
    device = next(model.parameters()).device
    model.eval()
    probs, labels = [], []
    kw = dict(mode="inference", deterministic=True, return_attention=False)
    with torch.no_grad():
        for j in range(0, len(graphs), batch_size):
            chunk = list(graphs[j:j + batch_size])
            batch = batch_graphs(chunk + [chunk[-1]] * (batch_size - len(chunk))).to(device)
            out = int8_apply(model, batch, **kw) if int8 else model(batch, **kw)
            logits = out["classification_logits"].double().cpu().numpy()[:len(chunk)]
            p = np.exp(logits - logits.max(-1, keepdims=True))
            probs.append(p / p.sum(-1, keepdims=True))
            labels.extend(int(g.y) for g in chunk)
    return np.concatenate(probs, axis=0), np.asarray(labels)


def run_gate(args, ap, spec: GateSpec):
    """Run variants x training seeds, write per-seed reports (+ pooled when
    multi-seed), return the last per-seed report."""
    from ..data.datamodule import BucketedLoader
    from ..evaluation.metrics import (
        bootstrap_ci, compute_classification_metrics, paired_bootstrap_delta,
    )
    from ..models import DGDMModel
    from ..nn.layers import init_parameters
    from ..ops.graph import batch_graphs
    from ..preprocessing import TissueGraphBuilder
    from ..training import DGDMTrainer, TrainerConfig

    script = Path(ap.prog or "gate").stem
    metric_fn = metric_fn_for(spec.num_classes)
    variants = build_variants(args, ap)
    windows = ([int(w) for w in str(args.window).split(",")]
               if args.window is not None else [])
    tseeds = ([int(s) for s in str(args.train_seed).split(",")]
              if getattr(args, "train_seed", None) is not None else [args.seed])
    device = torch.device(spec.device)

    cache_dir = args.out / "graph_cache"
    cache_dir.mkdir(parents=True, exist_ok=True)
    n_slides = len(spec.train_items) + len(spec.test_items)
    prep_stats = {"s": 0.0, "n": 0, "misses": 0}

    def load_graphs(knn_window):
        """Preprocess (or load cached) graphs for one graph-build config."""
        builder = TissueGraphBuilder(
            extractor=spec.extractor, node_buckets=(spec.bucket,),
            spatial_sort=knn_window is not None, knn_window=knn_window,
            per_slide_feature_norm=args.per_slide_norm, device=device)
        tag = cache_tag(spec, knn_window, args.per_slide_norm)
        print(f"[{script}] preprocessing slides -> graphs (bucket={spec.bucket}, "
              f"knn_window={knn_window}, cache={cache_dir})", flush=True)
        t0 = time.time()

        def fetch(items):
            paths = [cache_dir / f"{p.stem}_b{spec.bucket}{tag}.npz" for p, _ in items]
            missing = [p for (p, _), c in zip(items, paths) if not c.exists()]
            prep_stats["misses"] += len(missing)
            absent = [p for p in missing if not p.exists()]
            if absent and spec.render_missing is not None:
                spec.render_missing(absent)
            graphs = [slide_to_graph(p, y, spec.processor, builder, cache_dir,
                                     spec.bucket, tag) for p, y in items]
            return graphs, [g.node_mask for g in graphs]

        tr, mask_tr = fetch(spec.train_items)
        te, mask_te = fetch(spec.test_items)
        prep_stats["s"] += time.time() - t0
        prep_stats["n"] += n_slides
        counts = np.asarray([int(m.sum()) for m in mask_tr + mask_te])
        real_node_stats[knn_window] = {
            "mean": round(float(counts.mean()), 1),
            "min": int(counts.min()), "max": int(counts.max())}
        print(f"[{script}] real nodes per graph (bucket {spec.bucket}): "
              f"mean {counts.mean():.0f}, min {counts.min()}, max {counts.max()}",
              flush=True)
        return tr, te

    def as_batches(graphs, idxs, bs):
        return [batch_graphs([graphs[i] for i in idxs[j:j + bs]])
                for j in range(0, len(idxs), bs)]

    def arm_config(tag, extra_kwargs, knn_window, pt):
        """Config-affecting inputs of one arm, persisted into the variant
        cache so that a resume into the same --out with other
        hyperparameters (or from the other framework) is refused."""
        return {
            "tag": tag, "model_kwargs": dict(extra_kwargs),
            "knn_window": knn_window,
            "pretrain_epochs": pt, "finetune_epochs": spec.finetune_epochs,
            "config": args.config, "hidden": list(spec.hidden),
            "heads": spec.heads, "diffusion_steps": spec.steps,
            "num_classes": spec.num_classes,
            "dropout": args.dropout, "weight_decay": args.weight_decay,
            "lr": args.lr or (1e-4 if spec.weights_loaded else 1e-3),
            "finetune_lr_factor": args.finetune_lr_factor,
            "selection": args.selection, "batch_size": args.batch_size,
            "extractor": spec.arch, "per_slide_norm": args.per_slide_norm,
            "bucket": spec.bucket, "max_patches": spec.max_patches,
            "patch_size": spec.patch_size, "data_seed": args.seed,
            "n_train_per_class": args.n_train_per_class,
            "n_test_per_class": args.n_test_per_class,
            "backend": BACKEND,
        }

    graph_memo: dict = {}
    env_memo: dict = {}
    real_node_stats: dict = {}

    def get_graphs(knn_window):
        if knn_window not in graph_memo:
            graph_memo[knn_window] = load_graphs(knn_window)
        return graph_memo[knn_window]

    def get_env(tag, extra_kwargs, pt, n_train_batches):
        if tag in env_memo:
            return env_memo[tag]
        if args.dropout is not None:
            extra_kwargs = dict(extra_kwargs, dropout=args.dropout)
        model_kw = dict(node_features=spec.extractor.feature_dim, hidden_dims=spec.hidden,
                        attention_heads=spec.heads, num_diffusion_steps=spec.steps,
                        graph_layers=4, num_classes=spec.num_classes, pooling="attention",
                        **extra_kwargs)
        # parameters are drawn on the host (the draws of any device) and copied in
        template = DGDMModel(**model_kw)
        model = DGDMModel(**model_kw).to(device)
        lr = args.lr or (1e-4 if spec.weights_loaded else 1e-3)
        tc = dict(learning_rate=lr, warmup_steps=min(100, n_train_batches),
                  max_epochs=pt + spec.finetune_epochs, pretrain_epochs=pt,
                  steps_per_epoch=n_train_batches)
        if args.weight_decay is not None:
            tc["weight_decay"] = args.weight_decay
        if args.finetune_lr_factor is not None:
            tc["finetune_lr_factor"] = args.finetune_lr_factor
        trainer = DGDMTrainer(model, TrainerConfig(**tc), device=device)
        env = {"model": model, "template": template, "trainer": trainer, "lr": lr,
               "init": lambda seed: init_parameters(template,
                                                    torch.Generator().manual_seed(seed))}
        env_memo[tag] = env
        return env

    def stored_scores(full_probs):
        """1-d tumor prob for binary, [N, C] otherwise."""
        return full_probs[:, 1] if spec.num_classes == 2 else full_probs

    def run_variant(tag, extra_kwargs, knn_window, pt_epochs, tseed):
        """Train + evaluate one (graph-build, model) config for one training
        seed. Returns the metrics dict with ``_probs``/``_labels`` stashed
        for paired bootstrap deltas."""
        pt = spec.pretrain_epochs if pt_epochs is None else pt_epochs
        cfg_fp = arm_config(tag, extra_kwargs, knn_window, pt)
        vsuffix = f"s{args.seed}" if tseed == args.seed else f"s{args.seed}t{tseed}"
        vcache = args.out / f"variant_{tag}_{vsuffix}.npz"
        if vcache.exists():
            with np.load(vcache, allow_pickle=True) as z:
                m = json.loads(str(z["metrics"]))
                arrays = {k: z[k] for k in z.files if k != "metrics"}
            # the JAX package writes no backend (and early arms no fingerprint)
            stored_cfg = {"backend": "jax", **(m.pop("_arm_config", None) or {})}
            diff = {k: (stored_cfg[k], cfg_fp[k]) for k in set(stored_cfg) & set(cfg_fp)
                    if stored_cfg[k] != cfg_fp[k]}
            if diff:
                raise SystemExit(
                    f"[{script}] {vcache} was trained with DIFFERENT "
                    f"hyperparameters than this invocation (stored vs "
                    f"requested: {diff}). Resuming would mix configs in one "
                    f"report — use a different --out or delete the stale "
                    f"variant cache.")
            m["_probs"] = arrays["probs"]
            m["_labels"] = arrays["labels"]
            if "probs_int8" in arrays:
                m["_probs_int8"] = arrays["probs_int8"]
            print(f"[{script}] [{tag}] resumed from {vcache} (auc={m.get('auc')})")
            return m
        train_graphs, test_graphs = get_graphs(knn_window)
        rng = np.random.RandomState(tseed)
        order = rng.permutation(len(spec.train_items))
        n_val = max(1, len(order) // 5)
        val_idx, tr_idx = order[:n_val], order[n_val:]
        # epoch-reshuffled training batches; val/test stay fixed
        train_loader = BucketedLoader([train_graphs[i] for i in tr_idx], args.batch_size,
                                      shuffle=True, seed=tseed)
        n_train_batches = len(train_loader)
        val_batches = as_batches(train_graphs, val_idx, args.batch_size)
        env = get_env(tag, extra_kwargs, pt, n_train_batches)
        model, trainer = env["model"], env["trainer"]
        trainer.current_epoch = 0   # re-entry for the next seed replicate
        trainer.history = []
        env["init"](tseed)
        model.load_state_dict(env["template"].state_dict())
        model.train()
        example = batch_graphs([train_graphs[i] for i in tr_idx[:args.batch_size]])
        trainer.init_state(tseed, example)
        print(f"[{script}] [{tag}] t{tseed} finetuning {args.config}: "
              f"{pt} pretrain + {spec.finetune_epochs} finetune "
              f"epochs x {n_train_batches} steps, lr={env['lr']}", flush=True)
        fit = trainer.fit(train_loader, val_batches,
                          max_epochs=pt + spec.finetune_epochs,
                          early_stopping_patience=(
                              10**9 if args.selection == "final"
                              else max(10, spec.finetune_epochs // 3)),
                          restore_best_params=args.selection != "final")
        full_probs, labels = predict_probs(model, test_graphs, args.batch_size)
        m = compute_classification_metrics(labels, full_probs)
        m["best_val_loss"] = fit["best_val_loss"]
        m["_probs"] = stored_scores(full_probs)
        m["_labels"] = labels
        print(f"[{script}] [{tag}] t{tseed} auc={m.get('auc')} f1={m.get('f1')}",
              flush=True)
        if args.ab_int8 and tag == "dense":
            # the same finetuned parameters through the int8 Dense path: the
            # end-task accuracy gate of the quantized serving path
            probs8, _ = predict_probs(model, test_graphs, args.batch_size, int8=True)
            m8 = compute_classification_metrics(labels, probs8)
            m["auc_int8"] = m8.get("auc")
            m["f1_int8"] = m8.get("f1")
            m["int8_auc_delta"] = (None if m.get("auc") is None
                                   else round(m8["auc"] - m["auc"], 4))
            m["_probs_int8"] = stored_scores(probs8)
            print(f"[{script}] [{tag}] t{tseed} int8: auc={m8.get('auc')} "
                  f"f1={m8.get('f1')} delta={m['int8_auc_delta']}")
        arrays = {"probs": m["_probs"], "labels": m["_labels"]}
        if m.get("_probs_int8") is not None:
            arrays["probs_int8"] = m["_probs_int8"]
        payload = {k: v for k, v in m.items() if not k.startswith("_")}
        payload["_arm_config"] = cfg_fp
        np.savez(vcache, metrics=json.dumps(payload, default=float), **arrays)
        return m

    def build_report(results, tseed):
        primary_tag = variants[0][0]
        metrics = results[primary_tag]
        labels_t = metrics["_labels"]
        auc_ci = bootstrap_ci(metric_fn, labels_t, metrics["_probs"], n_bootstrap=2000)
        target = spec.reference_target or {}
        report = {
            "dataset": spec.dataset_name,
            "config": args.config,
            "hidden_dims": list(spec.hidden),
            "per_slide_norm": args.per_slide_norm,
            "selection": args.selection,
            "seed": args.seed,
            "train_seed": tseed,
            "extractor": spec.arch,
            "vit_weights": str(args.vit_weights) if args.vit_weights else None,
            "backbone_pretrained": spec.weights_loaded,
            "n_train": len(spec.train_items),
            "n_test": len(spec.test_items),
            "bucket": spec.bucket, "max_patches": spec.max_patches,
            "auc": metrics.get("auc"), "f1": metrics.get("f1"),
            "auc_ci95": [round(auc_ci["lower"], 4), round(auc_ci["upper"], 4)],
            "accuracy": metrics.get("accuracy"),
            "auc_int8": metrics.get("auc_int8"),
            "int8_auc_delta": metrics.get("int8_auc_delta"),
            "reference_target": spec.reference_target,
            "auc_delta_vs_reference": (
                None if metrics.get("auc") is None or not target.get("auc")
                else round(metrics["auc"] - target["auc"], 4)),
            "parity_valid": spec.weights_loaded and not args.synthetic,
            "preprocess_s_per_slide": round(prep_stats["s"] / max(prep_stats["n"], 1), 2),
            "best_val_loss": metrics["best_val_loss"],
            "wall_s": round(time.time() - spec.t_start, 1),
            "device": device_name(device),
        }
        report.update(spec.report_extra)
        if real_node_stats:
            report["real_nodes"] = (real_node_stats.get(None)
                                    or next(iter(real_node_stats.values())))
        # window-binding diagnostic: a ±1-block band constrains real-node
        # pairs only when the real nodes span >= 3 Morton blocks
        wb = {}
        for vtag, _kw, knnw, _pt in variants:
            stats = real_node_stats.get(knnw)
            if knnw and stats:
                blocks = stats["mean"] / knnw
                wb[vtag] = {"blocks_spanned_mean": round(blocks, 1),
                            "binds": bool(blocks >= 3)}
        if wb:
            report["window_binding"] = wb
        if len(results) > 1:
            report["variants"] = {
                t: {k: r.get(k) for k in ("auc", "f1", "accuracy", "best_val_loss")}
                for t, r in results.items()}
            # paired bootstrap deltas vs the primary variant, on the same
            # resampled slide sets
            for vtag, _, _, _ in variants[1:]:
                r = results[vtag]
                if r.get("auc") is None or metrics.get("auc") is None:
                    continue
                if vtag == "scratch":
                    d = paired_bootstrap_delta(metric_fn, labels_t, r["_probs"],
                                               metrics["_probs"])
                    report["pretrain_auc_uplift"] = {
                        "delta": round(d["delta"], 4),
                        "ci95": [round(d["lower"], 4), round(d["upper"], 4)]}
                else:
                    d = paired_bootstrap_delta(metric_fn, labels_t, metrics["_probs"],
                                               r["_probs"])
                    key = ("window_auc_delta_vs_dense"
                           if windows and vtag == f"window{windows[0]}"
                           else f"{vtag}_auc_delta_vs_dense")
                    report[key] = round(r["auc"] - metrics["auc"], 4)
                    report[key + "_ci95"] = [round(d["lower"], 4), round(d["upper"], 4)]
        if args.ab_int8 and metrics.get("_probs_int8") is not None:
            d = paired_bootstrap_delta(metric_fn, labels_t, metrics["_probs"],
                                       metrics["_probs_int8"])
            report["int8_auc_delta_ci95"] = [round(d["lower"], 4), round(d["upper"], 4)]
        return report

    if getattr(args, "prep_only", False):
        # build-or-refresh every graph-build config's cache, then exit
        for knnw in dict.fromkeys(knnw for _, _, knnw, _ in variants):
            get_graphs(knnw)
        print(f"[{script}] --prep-only: graph caches ready under {cache_dir} "
              f"({prep_stats['n']} slide-configs, {prep_stats['misses']} built, "
              f"{prep_stats['s']:.0f}s)", flush=True)
        return None

    report = None
    for tseed in tseeds:
        results = {tag: run_variant(tag, kw, knnw, pt, tseed)
                   for tag, kw, knnw, pt in variants}
        report = build_report(results, tseed)
        report["graph_cache_misses"] = prep_stats["misses"]
        name = args.report_name
        if tseed != args.seed:
            stem, dot, ext = name.partition(".")
            name = f"{stem}_t{tseed}{dot}{ext}"
        out_path = args.out / name
        if out_path.exists():
            # resumed arms skip graph loading: keep the previous report's
            # window_binding / real_nodes entries
            try:
                old = json.loads(out_path.read_text())
            except (OSError, json.JSONDecodeError):
                old = {}
            merged = {**(old.get("window_binding") or {}),
                      **(report.get("window_binding") or {})}
            if merged:
                report["window_binding"] = merged
            if "real_nodes" not in report and "real_nodes" in old:
                report["real_nodes"] = old["real_nodes"]
        out_path.write_text(json.dumps(report, indent=2))
        print(json.dumps(report, indent=2))
        print(f"[{script}] report -> {out_path}", flush=True)
    if len(tseeds) > 1:
        # refresh the pooled report over every arm npz in --out
        from . import aggregate_hard_seeds
        try:
            aggregate_hard_seeds.main(["--dir", str(args.out)]
                                      + (["--cpu"] if device.type == "cpu" else []))
        except SystemExit as e:
            print(f"[{script}] pooled aggregation skipped: {e}")
    if not report["parity_valid"]:
        print(f"[{script}] NOTE: this run does NOT establish reference "
              "parity (synthetic data and/or random-init backbone).")
    return report
