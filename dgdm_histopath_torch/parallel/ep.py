"""Expert parallelism for the MoE tier over an ``expert`` mesh axis
(counterpart of the JAX package's ``parallel/ep.py``).

The layout is the JAX package's: the per-expert leaves ``w_in``, ``b_in``,
``w_out`` and ``b_out`` of ``nn.moe.MoEFFN`` shard their leading ``[E]``
axis over ``expert`` when ``E`` divides by its size; everything else, the
router included (every rank needs its output), replicates.

JAX gets the computation from GSPMD. Here ``place_experts`` keeps this
rank's ``E / ep`` experts and makes the block an ``EPMoEFFN`` over its
``expert`` line; the block then routes every token as one process does (capacity, slot order,
drops and the aux loss unchanged), takes the dispatch slice, the expert FFN
and the combine of its own experts only, and sums the combine over the
line in f32. The tokens are the same on every rank of the line, as in every
caller of the JAX package, so no all-to-all arises (the one of the JAX
docstring needs tokens sharded over ``expert``); with the replicated-loss
collectives of ``mesh.py`` the gradient of the tokens' expert branch is
summed over the line and the combine weights' gradient gathered, so the
router's gradient is whole on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..nn.moe import MoEFFN
from .mesh import Axis, Mesh, copy_to_line, reduce_from_line, scatter_to_line
from .tp import flatten_specs

EXPERT_AXIS = "expert"

#: leaf names of per-expert parameters in ``nn.moe.MoEFFN`` (leading E axis)
EXPERT_LEAVES = frozenset({"w_in", "b_in", "w_out", "b_out"})


def ep_size(mesh: Mesh) -> int:
    """Size of the ``expert`` axis (1 when the mesh has none)."""
    return mesh.shape[mesh.axes.index(EXPERT_AXIS)] if EXPERT_AXIS in mesh.axes else 1


def ep_param_specs(params: Mapping, mesh: Mesh) -> Dict[str, Any]:
    """The spec tree of a JAX-layout parameter tree: expert leaves whose
    leading ``[E]`` divides by the ``expert`` size get ``("expert",)``,
    every other leaf ``()`` (all replicated without an ``expert`` axis
    above 1)."""
    ep = ep_size(mesh)

    def walk(node: Mapping) -> Dict[str, Any]:
        out = {}
        for name, child in node.items():
            if isinstance(child, Mapping):
                out[name] = walk(child)
            elif (ep > 1 and name in EXPERT_LEAVES and hasattr(child, "shape")
                  and child.shape[0] % ep == 0):
                out[name] = (EXPERT_AXIS,)
            else:
                out[name] = ()
        return out

    return walk(params)


def count_expert_sharded(specs: Mapping) -> int:
    """Number of leaves laid out over the expert axis."""
    return sum(1 for s in flatten_specs(specs).values() if s and s[0] == EXPERT_AXIS)


class EPMoEFFN(MoEFFN):
    """An ``MoEFFN`` that holds this rank's block of the experts over
    ``axis``: it routes every token, computes its experts' part of the
    combine, and the parts are summed over the line in f32."""

    axis: Axis

    def experts(self, xg: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
                deterministic: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        ax, n = self.axis, self.w_in.shape[0]
        part = super().experts(copy_to_line(xg, ax),
                               dispatch[:, :, ax.index * n:(ax.index + 1) * n],
                               scatter_to_line(combine, ax, 2), deterministic, generator)
        return reduce_from_line(part.float(), ax).to(part.dtype)


def place_experts(moe: MoEFFN, mesh: Mesh) -> int:
    """Keep this rank's block of ``moe``'s experts, in place, and make it an
    ``EPMoEFFN`` over its ``expert`` line; returns the leaves sharded (0 on
    a mesh without an ``expert`` axis above 1)."""
    if isinstance(moe, EPMoEFFN):
        return len(EXPERT_LEAVES)
    ep = ep_size(mesh)
    if ep == 1:
        return 0
    if moe.num_experts % ep:
        raise ValueError(f"{moe.num_experts} experts do not split over an expert axis of {ep}")
    axis = mesh.axis(EXPERT_AXIS)
    n = moe.num_experts // ep
    for name in sorted(EXPERT_LEAVES):
        full = getattr(moe, name)
        setattr(moe, name, nn.Parameter(full.detach()[axis.index * n:(axis.index + 1) * n]
                                        .clone(), requires_grad=full.requires_grad))
    moe.__class__ = EPMoEFFN
    moe.axis = axis
    return len(EXPERT_LEAVES)


__all__ = ["EPMoEFFN", "EXPERT_AXIS", "EXPERT_LEAVES", "count_expert_sharded", "ep_param_specs",
           "ep_size", "place_experts"]

