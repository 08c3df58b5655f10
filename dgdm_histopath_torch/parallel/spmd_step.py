"""The explicit-collective data-parallel train step (counterpart of the JAX
package's ``parallel/spmd_step.py``).

Each rank computes the mean loss of its own rows, with its draws seeded from
``(seed, step)`` folded with its rank; then gradients and metrics are
averaged over the ``data`` axis by one all-reduce, and every rank applies
the same clip + AdamW update. With equal shards of equally weighted rows
the update equals the one of the global batch. ``DGDMTrainer(mesh=...)``
is the other path: it takes every batch mean over the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .mesh import DATA_AXIS, Mesh


def make_spmd_train_step(loss_fn: Callable, model: torch.nn.Module, config, mesh: Mesh,
                         seed: int = 0) -> Callable:
    """``loss_fn(batch, generator) -> (loss, metrics)`` computes this rank's
    local mean loss. Returns ``step(batch) -> metrics`` (host floats, with
    ``loss`` and ``grad_norm``); ``batch`` is this rank's rows. ``config``
    is a ``TrainerConfig`` (learning rate, schedule, decay, clip)."""
    from ..training.trainer import _fold, clip_and_step, make_lr_schedule, make_optimizer

    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = make_optimizer(config, params)
    schedule = make_lr_schedule(config)
    generator = torch.Generator(device=params[0].device)
    state = {"step": 0}

    def step(batch) -> Dict[str, float]:
        generator.manual_seed(_fold(_fold(seed, state["step"]), 1 + mesh.rank))
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, generator)
        loss.float().backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        metrics = {**metrics, "loss": loss}
        names = sorted(metrics)
        # the collective: one mean of gradients and metrics over the data axis
        values = mesh.sum_grads(grads, torch.stack([metrics[k].detach().float()
                                                    for k in names])) / mesh.size
        torch._foreach_div_(grads, mesh.size)
        norm = clip_and_step(params, optimizer, schedule(state["step"]),
                             config.gradient_clip_val)
        state["step"] += 1
        out = dict(zip(names, values.tolist()))
        out["grad_norm"] = float(norm)
        return out

    return step


def hierarchical_pmean(tensor: torch.Tensor, intra: Mesh, inter: Optional[Mesh] = None
                       ) -> torch.Tensor:
    """Mean within a node's ranks first (``intra``), then across nodes
    (``inter``); with one mesh it is a plain mean. In place."""
    for mesh in (intra, inter):
        if mesh is not None:
            mesh.all_reduce(tensor).div_(mesh.size)
    return tensor


__all__ = ["DATA_AXIS", "hierarchical_pmean", "make_spmd_train_step"]
