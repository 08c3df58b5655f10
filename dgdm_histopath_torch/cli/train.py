"""``dgdm-train`` on the port: training, resume and checkpoint validation
(counterpart of the JAX package's ``cli/train.py``; the same flags, plus
``--device``).

    python -m dgdm_histopath_torch.cli.train train --preset dgdm-base \\
        --data-dir graphs/ --dataset-type graph --metadata labels.json \\
        --num-classes 2 --output-dir out/
    python -m dgdm_histopath_torch.cli.train resume --checkpoint-dir out/checkpoints ...
    python -m dgdm_histopath_torch.cli.train validate --checkpoint-dir out/checkpoints ...

A run writes ``config_snapshot.yaml``, ``checkpoints/`` (``index.json`` and
one directory per kept epoch), ``logs/metrics.{csv,jsonl}``,
``final_model.npz`` (a bundle the JAX package reads too) and
``history.json``. SIGTERM stops it at the next step boundary with an
emergency checkpoint and exit code 75; ``resume`` re-enters the same epoch
and replays the remaining steps bit for bit. It runs on the card unless
``--device cpu`` is given; asking for the card without one is an error.

Data parallelism: the world is ``prod(--mesh-shape)`` (or
``hardware.mesh_shape``) when given, else every visible card (1 for
``--device cpu``); ``--devices`` is read by nothing, as in the reference.
A world above 1 spawns one rank a card (``cuda:r``) over NCCL, or ranks on
the CPU over gloo, meeting at a file rendezvous in the output directory.
Rank 0 alone writes the outputs; a SIGTERM to the launcher reaches every
rank, they stop at the same step and the launcher exits 75 (130 when the
signal came before training began, as for one process). A mesh axis
other than ``data`` above 1 raises naming ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np

from ..parallel.mesh import make_mesh
from ..utils.config import DGDMConfig, config_to_dict, load_config, save_config
from ..utils.device import resolve_device
from ..utils.logging import get_logger, setup_logging
from ..utils.validation import InputValidator

logger = get_logger("cli")

EX_TEMPFAIL = 75     # preempted: the scheduler should run `resume`
EX_INTERRUPTED = 130  # a signal before training began: nothing to resume
RENDEZVOUS = ".dist_rendezvous"   # the ranks' file rendezvous in the output directory


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgdm-train",
                                description="Train a DGDM model on histopathology data")
    sub = p.add_subparsers(dest="command")

    def add_common(sp):
        sp.add_argument("--config", type=str, default=None, help="YAML or JSON config path")
        sp.add_argument("--preset", type=str, default=None,
                        help="model preset: dgdm-base|dgdm-large|dgdm-clinical|dgdm-small")
        sp.add_argument("--data-dir", type=str, required=False)
        sp.add_argument("--output-dir", type=str, default="./outputs")
        sp.add_argument("--dataset-type", choices=["slide", "graph", "patch"], default=None)
        sp.add_argument("--metadata", type=str, default=None, help="labels json/csv")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to train (default: the card)")
        # model
        sp.add_argument("--node-features", type=int, default=None)
        sp.add_argument("--hidden-dims", type=str, default=None,
                        help="comma-separated, e.g. 512,256,128")
        sp.add_argument("--num-diffusion-steps", type=int, default=None)
        sp.add_argument("--attention-heads", type=int, default=None)
        sp.add_argument("--graph-layers", type=int, default=None)
        sp.add_argument("--dropout", type=float, default=None)
        sp.add_argument("--pooling", choices=["mean", "max", "attention", "set2set"],
                        default=None)
        sp.add_argument("--num-classes", type=int, default=None)
        sp.add_argument("--regression-targets", type=int, default=None)
        sp.add_argument("--survival-mode", choices=["cox", "discrete"], default=None,
                        help="enable the survival task (labels are (time, event) pairs)")
        sp.add_argument("--survival-intervals", type=int, default=None)
        # training
        sp.add_argument("--max-epochs", type=int, default=None)
        sp.add_argument("--pretrain-epochs", type=int, default=None)
        sp.add_argument("--learning-rate", type=float, default=None)
        sp.add_argument("--weight-decay", type=float, default=None)
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--masking-ratio", type=float, default=None)
        sp.add_argument("--scheduler", choices=["cosine", "onecycle", "none"], default=None)
        # hardware
        sp.add_argument("--devices", type=int, default=None,
                        help="kept for config compatibility; read by nothing, as in "
                             "the reference (the mesh spans every visible card)")
        sp.add_argument("--mesh-shape", type=str, default=None,
                        help="comma ints, e.g. '4' (4-way data parallel); an axis other "
                             "than data above 1 is not ported")
        sp.add_argument("--mesh-axes", type=str, default=None,
                        help="comma names matching --mesh-shape; default 'data' or "
                             "'data,model'")
        sp.add_argument("--precision", choices=["32", "bf16-mixed", "16-mixed"], default=None)
        # logging
        sp.add_argument("--log-level", default="INFO")
        sp.add_argument("--log-file", default=None)
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--save-top-k", type=int, default=None)
        sp.add_argument("--early-stopping-patience", type=int, default=10)

    train_p = sub.add_parser("train", help="train a model")
    add_common(train_p)
    resume_p = sub.add_parser("resume", help="resume from checkpoint dir")
    add_common(resume_p)
    resume_p.add_argument("--checkpoint-dir", type=str, required=True)
    val_p = sub.add_parser("validate", help="validate a checkpoint")
    add_common(val_p)
    val_p.add_argument("--checkpoint-dir", type=str, required=True)
    add_common(p)   # no command: train
    return p


def merge_cli_config(args: argparse.Namespace) -> DGDMConfig:
    """The config file (if any), then the preset, then each flag given, then
    the ``DGDM_*`` environment; validated."""
    overrides: dict = {"model": {}, "training": {}, "data": {},
                       "hardware": {}, "logging": {}, "experiment": {}}
    m, t, d, h = (overrides["model"], overrides["training"], overrides["data"],
                  overrides["hardware"])
    if getattr(args, "preset", None):
        from ..models.presets import PRESETS
        if args.preset not in PRESETS:
            raise SystemExit(f"unknown preset {args.preset!r}; options: {sorted(PRESETS)}")
        m.update({k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in PRESETS[args.preset].items() if k != "label_note"})
    for flag, key in (("node_features", "node_features"),
                      ("num_diffusion_steps", "num_diffusion_steps"),
                      ("attention_heads", "attention_heads"), ("graph_layers", "graph_layers"),
                      ("dropout", "dropout"), ("pooling", "pooling"),
                      ("num_classes", "num_classes"),
                      ("regression_targets", "regression_targets")):
        if getattr(args, flag) is not None:
            m[key] = getattr(args, flag)
    if args.hidden_dims is not None:
        m["hidden_dims"] = [int(x) for x in args.hidden_dims.split(",")]
    if getattr(args, "survival_mode", None) is not None:
        overrides["survival"] = {"enabled": True, "mode": args.survival_mode}
        if args.survival_intervals is not None:
            overrides["survival"]["num_intervals"] = args.survival_intervals
    for flag, key in (("max_epochs", "max_epochs"), ("pretrain_epochs", "pretrain_epochs"),
                      ("learning_rate", "learning_rate"), ("weight_decay", "weight_decay"),
                      ("masking_ratio", "masking_ratio"), ("scheduler", "scheduler_type")):
        if getattr(args, flag) is not None:
            t[key] = getattr(args, flag)
    if args.batch_size is not None:
        d["batch_size"] = args.batch_size
    if args.dataset_type is not None:
        d["dataset_type"] = args.dataset_type
    if args.devices is not None:
        h["devices"] = args.devices
    if getattr(args, "mesh_shape", None):
        shape = [int(x) for x in args.mesh_shape.split(",")]
        h["mesh_shape"] = shape
        if getattr(args, "mesh_axes", None):
            h["mesh_axes"] = [a.strip() for a in args.mesh_axes.split(",")]
        else:
            h["mesh_axes"] = (["data", "model"][:len(shape)] if len(shape) <= 2
                              else [f"axis{i}" for i in range(len(shape))])
    if args.precision is not None:
        h["precision"] = args.precision
    if args.seed is not None:
        overrides["experiment"]["seed"] = args.seed
    if args.save_top_k is not None:
        overrides["logging"]["save_top_k"] = args.save_top_k
    return load_config(args.config, overrides=overrides)


def _build_dataset(cfg: DGDMConfig, args, device):
    from ..data import HistopathDataset, SlideDataset, load_labels
    from ..preprocessing.slide_processor import SlideProcessor
    from ..preprocessing.tissue_graph_builder import TissueGraphBuilder

    data_dir = Path(args.data_dir)
    if cfg.data.dataset_type == "graph":
        return HistopathDataset(data_dir, dataset_type="graph", metadata_path=args.metadata,
                                augmentations=cfg.data.augmentations)
    labels = load_labels(args.metadata) if args.metadata else {}
    proc = SlideProcessor(patch_size=cfg.data.patch_size,
                          magnifications=cfg.data.magnifications,
                          tissue_threshold=cfg.data.tissue_threshold,
                          max_patches=cfg.data.max_patches, device=device)
    builder = TissueGraphBuilder(feature_extractor=cfg.data.feature_extractor,
                                 node_buckets=cfg.data.node_buckets,
                                 spatial_sort=cfg.data.spatial_sort,
                                 knn_window=cfg.data.knn_window, device=device)
    paths = sorted(p for p in data_dir.rglob("*")
                   if p.suffix.lower() in (".svs", ".tiff", ".tif", ".ndpi", ".wsi"))
    return SlideDataset(paths, processor=proc, graph_builder=builder, labels=labels,
                        augmentations=cfg.data.augmentations)


def _trainer(cfg: DGDMConfig, example, device, mesh=None):
    """``DGDMTrainer.from_config`` with the model's edge width read off the
    data: the JAX model infers it from its input, the port's layers fix it
    at construction."""
    from ..training import DGDMTrainer
    edge_dim = int(example.edge_attr.shape[-1])
    if edge_dim != cfg.model.edge_features:
        logger.info("model.edge_features %d -> %d (the graphs' edge width)",
                    cfg.model.edge_features, edge_dim)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 edge_features=edge_dim))
    return DGDMTrainer.from_config(cfg, device=device, mesh=mesh)


def _execute_training(cfg: DGDMConfig, args, device, resume_dir=None) -> int:
    from ..data import HistopathDataModule
    from ..training import CheckpointManager, PreemptionGuard, save_model_bundle
    from ..training.experiment_logging import make_logger

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = _rank() == 0
    if writer:
        save_config(cfg, out_dir / "config_snapshot.yaml")

    dataset = _build_dataset(cfg, args, device)
    if len(dataset) == 0:
        logger.error("no data found in %s", args.data_dir)
        return 1
    dm = HistopathDataModule(
        dataset, batch_size=cfg.data.batch_size, train_split=cfg.data.train_split,
        val_split=cfg.data.val_split, test_split=cfg.data.test_split,
        shuffle_train=cfg.data.shuffle_train, seed=cfg.experiment.seed)
    dm.setup()
    logger.info("dataset: %s", dm.get_dataset_info())

    example = next(iter(dm.train_dataloader()))
    trainer = _trainer(cfg, example, device)
    # as in the reference, after the schedule was built: it keeps the
    # default horizon of 1000 steps an epoch
    trainer.config.steps_per_epoch = max(1, len(dm.train_dataloader()))
    trainer.init_state(cfg.experiment.seed, example)

    ckpt_dir = Path(resume_dir) if resume_dir else out_dir / "checkpoints"
    # rank 0 writes the checkpoints; every rank restores from them
    mgr = (CheckpointManager(ckpt_dir, save_top_k=cfg.logging.save_top_k,
                             monitor=cfg.logging.monitor_metric)
           if writer or resume_dir else None)
    start_step_in_epoch = 0
    if resume_dir and mgr.last_step is not None:
        trainer.load_state_dict(mgr.restore())
        resume_meta = mgr.record_extra(mgr.last_step).get("resume")
        if resume_meta and resume_meta.get("mid_epoch"):
            # a preemption checkpoint: re-enter the same epoch and skip the
            # steps already taken
            trainer.current_epoch = int(resume_meta["epoch"])
            start_step_in_epoch = int(resume_meta["step_in_epoch"])
            logger.info("resumed mid-epoch: epoch %d step %d", trainer.current_epoch,
                        start_step_in_epoch)
        else:
            trainer.current_epoch = mgr.last_step + 1
            logger.info("resumed from epoch %d", trainer.current_epoch)

    train_logger = None
    if writer:
        train_logger = make_logger(cfg.logging, out_dir / "logs",
                                   run_name=cfg.experiment.name or None)
        train_logger.log_hparams(config_to_dict(cfg))
    guard = PreemptionGuard(install=True)
    try:
        result = trainer.fit(
            dm.train_dataloader(), dm.val_dataloader(), max_epochs=cfg.training.max_epochs,
            checkpoint_manager=mgr if writer else None,
            early_stopping_patience=args.early_stopping_patience,
            train_logger=train_logger, preemption_guard=guard,
            start_step_in_epoch=start_step_in_epoch)
    finally:
        guard.uninstall()
        if train_logger is not None:
            train_logger.close()
    if result.get("interrupted"):
        logger.warning("training preempted at %s; resume with "
                       "`dgdm-train resume --checkpoint-dir %s`", result.get("resume"),
                       ckpt_dir)
        return EX_TEMPFAIL

    test_losses = [float(trainer.validation_step(b)["loss"]) for b in dm.test_dataloader()]
    if test_losses:
        result["test_loss"] = float(np.mean(test_losses))
        logger.info("test_loss=%.4f", result["test_loss"])
    if not writer:
        return 0

    model = trainer.model
    model_cfg = {
        "node_features": cfg.model.node_features,
        "hidden_dims": list(cfg.model.hidden_dims),
        "num_diffusion_steps": cfg.model.num_diffusion_steps,
        "attention_heads": cfg.model.attention_heads,
        "dropout": cfg.model.dropout,
        "graph_layers": cfg.model.graph_layers,
        "use_spatial_attention": cfg.model.use_spatial_attention,
        "use_hierarchical": cfg.model.use_hierarchical,
        "pooling": cfg.model.pooling,
        "num_classes": model.num_classes,
        "regression_targets": model.regression_targets,
        "survival_mode": model.survival_mode,
        "survival_intervals": model.survival_intervals,
        "compute_dtype": cfg.model.compute_dtype,
    }
    if cfg.model.moe_experts:
        # the JAX CLI leaves these out, and its bundle of an MoE model then
        # builds no MoE block; the port writes them so that the bundle loads
        model_cfg.update(moe_experts=cfg.model.moe_experts, moe_top_k=cfg.model.moe_top_k,
                         moe_capacity=cfg.model.moe_capacity)
    save_model_bundle(out_dir / "final_model.npz", model, model_cfg,
                      extra={"history_len": len(result["history"])})
    (out_dir / "history.json").write_text(json.dumps(result["history"], indent=2))
    logger.info("training complete; outputs in %s", out_dir)
    return 0


def _validate(cfg: DGDMConfig, args, device) -> int:
    from ..data import HistopathDataModule
    from ..training import CheckpointManager

    dataset = _build_dataset(cfg, args, device)
    dm = HistopathDataModule(dataset, batch_size=cfg.data.batch_size, seed=cfg.experiment.seed)
    dm.setup()
    example = next(iter(dm.val_dataloader()))
    trainer = _trainer(cfg, example, device, mesh=make_mesh())   # one process
    trainer.init_state(0, example)
    trainer.load_state_dict(CheckpointManager(args.checkpoint_dir).restore(best=True))
    # the reference keeps no epoch in its checkpoints: it validates in the
    # phase of epoch 0
    losses = [float(trainer.validation_step(b, epoch=0)["loss"]) for b in dm.val_dataloader()]
    print(json.dumps({"val_loss": float(np.mean(losses)), "batches": len(losses)}))
    return 0


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size(cfg: DGDMConfig, device) -> int:
    """The ranks a run takes: ``prod(mesh_shape)`` when set, else every
    visible card (one process on the CPU). A mesh axis other than ``data``
    above 1 raises naming ROADMAP item 12; a CUDA world larger than the
    visible cards raises."""
    import torch

    from ..parallel.mesh import check_axes
    hw = cfg.hardware
    if hw.mesh_shape:
        check_axes(hw.mesh_axes, hw.mesh_shape)
        world = math.prod(hw.mesh_shape)
    else:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a world of {world} ranks needs {world} cards; "
                         f"{torch.cuda.device_count()} are visible (NCCL takes one a rank)")
    return world


def _run(args, cfg: DGDMConfig, device) -> int:
    if args.command == "resume":
        return _execute_training(cfg, args, device, resume_dir=args.checkpoint_dir)
    if args.command == "validate":
        return _validate(cfg, args, device)
    return _execute_training(cfg, args, device)


@contextlib.contextmanager
def _exit_on_signal():
    """SIGINT and SIGTERM exit with 130 until ``fit``'s preemption guard
    takes them over (and after it gives them back)."""
    previous = {sig: signal.signal(sig, lambda s, f: sys.exit(EX_INTERRUPTED))
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _rank_main(rank: int, world: int, argv, rendezvous: str) -> None:
    """One rank of a data-parallel run: its process group, its device, the
    command; exits with the command's code."""
    with _exit_on_signal():
        import torch
        import torch.distributed as dist

        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        args = build_parser().parse_args(argv)
        setup_logging(args.log_level, args.log_file)
        if args.device == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            device = torch.device("cpu")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{rendezvous}", world_size=world,
                                rank=rank)
        try:
            code = _run(args, merge_cli_config(args), device)
        finally:
            dist.destroy_process_group()
        sys.exit(code)


def _launch(argv, world: int, out_dir: Path) -> int:
    """Spawn ``world`` ranks and wait for them; a SIGTERM or SIGINT to this
    process is passed to every rank. Returns the ranks' exit code (75 when
    they were preempted); a rank that fails stops the others."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rendezvous = (out_dir / RENDEZVOUS).absolute()
    rendezvous.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, argv, str(rendezvous)),
                         name=f"dgdm-train-rank{r}") for r in range(world)]
    for p in procs:
        p.start()

    def forward(sig, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    previous = {sig: signal.signal(sig, forward) for sig in (signal.SIGINT, signal.SIGTERM)}
    stopped = (None, 0, EX_TEMPFAIL, EX_INTERRUPTED)
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in stopped for p in procs):
                for p in procs:
                    if p.is_alive():
                        p.kill()
            time.sleep(0.2)
        for p in procs:
            p.join()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        rendezvous.unlink(missing_ok=True)
    codes = [p.exitcode for p in procs]
    logger.info("ranks exited with %s", codes)
    return launcher_code(codes)


def launcher_code(codes) -> int:
    """The launcher's exit code from its ranks': 1 when one failed, else 130
    when one was stopped before training began, else 75 when they were
    preempted, else 0."""
    if any(c not in (0, EX_TEMPFAIL, EX_INTERRUPTED) for c in codes):
        return 1
    for code in (EX_INTERRUPTED, EX_TEMPFAIL):
        if code in codes:
            return code
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level, args.log_file)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(f"{exc} (--device cpu)")
    if args.data_dir is None and args.command != "validate":
        parser.error("--data-dir is required")
    InputValidator.validate_path(args.data_dir, "data_dir", must_exist=True)
    cfg = merge_cli_config(args)
    world = 1 if args.command == "validate" else world_size(cfg, device)
    if world > 1:
        return _launch(sys.argv[1:] if argv is None else list(argv), world,
                       Path(args.output_dir))
    with _exit_on_signal():
        return _run(args, cfg, device)


if __name__ == "__main__":
    sys.exit(main())
