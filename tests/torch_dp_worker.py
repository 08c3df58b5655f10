"""Ranks of the data-parallel tests (tests/test_torch_dp.py): spawned
processes that import torch and the port only.

``spawn_ranks(world, specs, tmp)`` saves ``specs`` (a list of dicts of plain
values and tensors), starts ``world`` spawned processes over a gloo group
that meets at a ``file://`` rendezvous under ``tmp`` (no port, so parallel
test workers never collide), runs each spec's ``job`` in turn in every rank
(with the spec's ``env`` set while it runs: ``LOCAL_WORLD_SIZE=1`` makes the
two ranks two nodes) and returns, per rank, the list of results. A spec's
``module`` names the module of its job (``torch_parallel_worker``), and its
``world`` a smaller group for it: ranks from ``world`` on sit it out (their
result is None), and the group is made anew where the size changes.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import sys
import traceback
from pathlib import Path

import torch


def spawn_ranks(world: int, specs: list, tmp: Path, timeout: float = 300.0) -> list:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(specs, tmp / "spec.pt")
    for stale in tmp.glob("rendezvous*"):
        stale.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, world, str(tmp))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"error{r}.txt") for r in range(world)]
    failed = [e.read_text() for e in errors if e.exists()]
    if failed or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks exited {[p.exitcode for p in procs]}:\n"
                             + "\n".join(failed))
    return [torch.load(tmp / f"result{r}.pt", weights_only=False) for r in range(world)]


def _main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    tmp = Path(tmp)
    here = Path(__file__).resolve()
    sys.path[:0] = [str(here.parents[1]), str(here.parent)]
    torch.set_num_threads(1)
    try:
        specs = torch.load(tmp / "spec.pt", weights_only=False)
        result, size = [], None
        try:
            for i, spec in enumerate(specs):
                if spec.get("world", world) != size:
                    size = spec.get("world", world)
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    if rank < size:
                        dist.init_process_group(
                            "gloo", init_method=f"file://{tmp / f'rendezvous{i}'}",
                            world_size=size, rank=rank)
                result.append(_run_job(spec, rank) if rank < size else None)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        torch.save(result, tmp / f"result{rank}.pt")
    except BaseException:  # noqa: BLE001 - reported to the parent
        (tmp / f"error{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def _run_job(spec, rank):
    saved = {k: os.environ.get(k) for k in spec.get("env", {})}
    os.environ.update(spec.get("env", {}))
    jobs = importlib.import_module(spec["module"]).JOBS if "module" in spec else JOBS
    try:
        return jobs[spec["job"]](spec, rank)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _trainer(spec):
    from dgdm_histopath_torch.models.dgdm import DGDMModel
    from dgdm_histopath_torch.parallel import make_mesh
    from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

    model = DGDMModel(**spec["model"])
    model.load_state_dict(spec["state"])
    if spec.get("moe_group"):
        model.moe_ffn.group_size = spec["moe_group"]
    trainer = DGDMTrainer(model, TrainerConfig(**spec["config"]), device="cpu",
                          mesh=make_mesh())
    trainer.init_state(seed=spec.get("seed", 0))
    return trainer


def train_steps(spec, rank) -> dict:
    """``spec["steps"]``: (batch, epoch, draws or None) global, or with
    ``rank_steps`` each rank's node batches; returns each step's metrics, a
    validation per epoch phase and the final parameters."""
    trainer = _trainer(spec)
    steps = spec["rank_steps"][rank] if "rank_steps" in spec else spec["steps"]
    if spec.get("expect_error"):
        try:
            trainer.training_step(*steps[0][:2])
        except ValueError as exc:
            return {"error": str(exc)}
        return {"error": None}
    metrics = [trainer.training_step(b, e, draws=d) for b, e, d in steps]
    val = [{k: v.clone() for k, v in trainer.validation_step(b, e, draws=d).items()}
           for b, e, d in spec.get("validate", [])]
    return {"metrics": metrics, "validation": val, "step": trainer.step,
            "params": {k: v.detach().clone() for k, v in trainer.model.named_parameters()}}


def fit_nodes(spec, rank) -> dict:
    """``fit`` over a datamodule that shards ``spec["graphs"]`` by node
    (run with two nodes of one rank): what each step trained on, the
    graphs this node's loader holds, and a run resumed at ``resume_at``."""
    from dgdm_histopath_torch.data import HistopathDataModule

    def module():
        return HistopathDataModule(spec["graphs"], batch_size=2, train_split=1.0,
                                   val_split=0.0, test_split=0.0, seed=spec["seed"])

    def fit(start):
        trainer = _trainer(spec)
        seen, step = [], trainer._step

        def counted(batch, *args, **kwargs):
            seen.append((tuple(batch.nbr_idx.shape), int(batch.node_mask.any(-1).sum())))
            return step(batch, *args, **kwargs)

        trainer._step = counted
        history = trainer.fit(module().train_dataloader(), max_epochs=spec["epochs"],
                              start_step_in_epoch=start)["history"]
        return {"seen": seen, "history": history}

    loaded = sum(int(b.node_mask.any(-1).sum()) for b in module().train_dataloader())
    return {"loaded": loaded, "shard": module().shard_index, "whole": fit(0),
            "resumed": fit(spec["resume_at"])}


def spmd_steps(spec, rank) -> dict:
    """``make_spmd_train_step`` over finetune losses: each rank takes its rows."""
    from dgdm_histopath_torch.parallel import make_mesh, make_spmd_train_step, shard_batch

    trainer = _trainer(spec)
    mesh = make_mesh()
    step = make_spmd_train_step(lambda b, g: trainer._finetune_losses(b, None),
                                trainer.model, trainer.config, mesh)
    # the loss function must see this rank's rows only: no data-parallel means
    trainer._dp = None
    metrics = [step(shard_batch(b, mesh)) for b, _, _ in spec["steps"]]
    return {"metrics": metrics,
            "params": {k: v.detach().clone() for k, v in trainer.model.named_parameters()}}


def gather_check(spec, rank) -> dict:
    """``Mesh.gather``'s forward and backward, and ``hierarchical_pmean``."""
    from dgdm_histopath_torch.parallel import hierarchical_pmean, make_mesh

    mesh = make_mesh()
    x = torch.full((2, 3), float(mesh.rank + 1), requires_grad=True)
    g = mesh.gather(x)
    (g * torch.arange(g.numel(), dtype=torch.float32).view_as(g)).sum().backward()
    mean = hierarchical_pmean(torch.tensor([float(mesh.rank)]), mesh)
    return {"gathered": g.detach(), "grad": x.grad, "mean": mean,
            "any": [mesh.any(mesh.rank == 1), mesh.any(False)],
            "mask": mesh.gather(torch.tensor([mesh.rank == 0, True]))}


JOBS = {"train_steps": train_steps, "fit_nodes": fit_nodes, "spmd_steps": spmd_steps,
        "gather_check": gather_check}
