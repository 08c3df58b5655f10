"""Data-parallel layout over ``torch.distributed`` ranks (counterpart of the
JAX package's ``parallel/mesh.py``).

A ``Mesh`` names its axes and their sizes, as a JAX mesh does; the only axis
this port runs is ``data``: each rank holds the whole model and takes a
contiguous block of rows of every global batch (rank ``r`` of ``W`` takes
rows ``[r·B/W, (r+1)·B/W)``, the order in which JAX lays a batch over its
devices). A ``data`` axis of 1 needs no process group: the trainer then runs
its single-process path. Any other axis above 1 raises naming its ROADMAP
item.

A node is a block of ``LOCAL_WORLD_SIZE`` consecutive ranks (as torchrun and
the train CLI set it; every rank when unset), the counterpart of a JAX
process. Each node loads its own training batches; its ranks split each of
them (``shard_batch(..., node=True)``), so the global batch is the nodes'
batches stacked in node order and rank ``r`` still holds global rows
``[r·b, (r+1)·b)``. Over several nodes ``align_node_batches`` brings every
rank's rows to one shape before a step.

Collectives are ``all_reduce`` and ``broadcast`` only, the two that the gloo
backend also runs on CUDA tensors, so one code path serves NCCL (one card a
rank) and gloo (the CPU, or ranks that share a card). Host-side agreement
(the preemption flag) goes over a gloo group of its own, so it needs no
device sync.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.graph import PaddedGraph

DATA_AXIS = "data"
_GRAPH = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")
NOT_PORTED = "{what} is not ported yet (ROADMAP queue 1, item 12)"


@dataclass
class Mesh:
    """Named axes over the ranks of a process group (``group`` None: one
    process, no collectives)."""

    axes: tuple
    shape: tuple
    group: Any = None
    control: Any = None      # a gloo group for host-side flags
    local: int = 1           # ranks a node

    @property
    def size(self) -> int:
        return self.shape[self.axes.index(DATA_AXIS)]

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def nodes(self) -> int:
        return self.size // self.local

    @property
    def local_rank(self) -> int:
        return self.rank % self.local

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def sum_grads(self, grads: Sequence[torch.Tensor], values: torch.Tensor) -> torch.Tensor:
        """Sum ``grads`` (in place) and the vector ``values`` over the ranks
        in one all-reduce; returns the summed ``values``."""
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads] + [values]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def max(self, values: Sequence[int]) -> list:
        """The largest of each of ``values`` over the ranks (host-side)."""
        t = torch.tensor(list(values), dtype=torch.int64)
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return t.tolist()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a host-side collective)."""
        return bool(self.max([int(flag)])[0])

    def mean(self, num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global batch mean: ``num / max(count over
        every rank, 1)``; the shares of all ranks sum to the mean."""
        total = self.all_reduce(count.detach().float().clone())
        return num / total.clamp_min(1.0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in rank order (equal
        shapes on every rank), with a gradient: the backward sums the
        incoming gradient over the ranks and keeps this rank's rows."""
        if x.dtype == torch.bool:
            return _GatherRows.apply(x.float(), self) > 0.5
        return _GatherRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    """An all-gather made of an all-reduce over a zero-filled buffer (gloo
    runs no all-gather on CUDA tensors); adding zeros leaves every row exact."""

    @staticmethod
    def forward(ctx, x, mesh):
        n, r = x.shape[0], mesh.rank
        buf = x.new_zeros((mesh.size * n,) + tuple(x.shape[1:]))
        buf[r * n:(r + 1) * n] = x
        ctx.mesh, ctx.rows = mesh, (r * n, (r + 1) * n)
        return mesh.all_reduce(buf)

    @staticmethod
    def backward(ctx, grad):
        grad = ctx.mesh.all_reduce(grad.contiguous().clone())
        lo, hi = ctx.rows
        return grad[lo:hi], None


def check_axes(axes: Sequence[str], shape: Sequence[int]) -> None:
    """Equal lengths, a ``data`` axis, and no other axis above 1 (those raise
    naming ROADMAP queue 1, item 12)."""
    if len(axes) != len(shape):
        raise ValueError(f"mesh axes {tuple(axes)} and shape {tuple(shape)} differ in length")
    if DATA_AXIS not in axes:
        raise ValueError(f"a mesh needs a {DATA_AXIS!r} axis, got {tuple(axes)}")
    for axis, size in zip(axes, shape):
        if axis != DATA_AXIS and size > 1:
            raise NotImplementedError(NOT_PORTED.format(
                what=f"the mesh axis {axis!r} of size {size} (tensor, sequence, pipeline "
                     f"and expert parallelism)"))


def local_world_size(world: int) -> int:
    """Ranks a node: ``LOCAL_WORLD_SIZE``, else all ``world`` of them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks of the initialized default process group (or
    over one process when none is). Default: a 1-D ``data`` mesh over
    every rank (``n_devices`` of them when given). A ``data`` size above 1
    needs a process group of exactly that many ranks, in nodes of
    ``local_world_size`` ranks."""
    axes = tuple(axes)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if shape is None:
        shape = [n_devices if n_devices is not None else world] + [1] * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    check_axes(axes, shape)
    size = math.prod(shape)
    if size != world and (size > 1 or initialized):
        raise ValueError(f"mesh shape {shape} needs {size} ranks; the process group has "
                         f"{world}" + ("" if initialized else " (none is initialized)"))
    if not initialized:
        return Mesh(axes, shape)
    local = local_world_size(world)
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of {world} ranks")
    control = (dist.group.WORLD if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo"))
    return Mesh(axes, shape, dist.group.WORLD, control, local)


def _fill_rows(batch: PaddedGraph, rem: int) -> PaddedGraph:
    """``rem`` filler graphs after the batch: its last graph repeated with
    an all-False ``node_mask`` and a zero ``nbr_mask``, so that they carry
    no weight in any loss."""
    if rem == 0:
        return batch

    def pad(t, zero=False):
        reps = t[-1:].repeat((rem,) + (1,) * (t.dim() - 1))
        return torch.cat([t, torch.zeros_like(reps) if zero else reps])

    return PaddedGraph(x=pad(batch.x), pos=pad(batch.pos), nbr_idx=pad(batch.nbr_idx),
                       nbr_mask=pad(batch.nbr_mask, True), edge_attr=pad(batch.edge_attr),
                       node_mask=pad(batch.node_mask, True),
                       y=None if batch.y is None else pad(batch.y))


def pad_batch_to_devices(batch: PaddedGraph, n_devices: int) -> PaddedGraph:
    """Fill the leading axis up to a multiple of ``n_devices`` with filler
    graphs."""
    return _fill_rows(batch, (-batch.x.shape[0]) % n_devices)


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of rows of ``t`` (a multiple of the
    ``data`` size long)."""
    n = t.shape[0] // mesh.size
    return t[mesh.rank * n:(mesh.rank + 1) * n]


def shard_batch(batch: PaddedGraph, mesh: Mesh, node: bool = False) -> PaddedGraph:
    """This rank's rows of a global batch (pad it first), or with ``node``
    of its node's batch (a block of ``mesh.local`` ranks splits it)."""
    parts, index = (mesh.local, mesh.local_rank) if node else (mesh.size, mesh.rank)
    b = batch.x.shape[0]
    if b % parts:
        raise ValueError(f"batch of {b} does not split over {parts} ranks")
    n = b // parts
    return batch.replace(**{f: getattr(batch, f)[index * n:(index + 1) * n] for f in _GRAPH
                            if getattr(batch, f) is not None})


def _grow(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t`` in the leading corner of zeros of ``shape``."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def align_node_batches(batch: Optional[PaddedGraph], like: Optional[PaddedGraph],
                       mesh: Mesh) -> Optional[PaddedGraph]:
    """Over several nodes, each loading its own batches: bring this rank's
    rows to the shape every rank agrees on, the most graphs, nodes and
    neighbours of any rank's (filler graphs, padding nodes and padding
    neighbours, none of which carries weight). A rank whose node has run
    out of batches (``batch`` None) while another's has not stands in
    filler graphs shaped like ``like``. Returns None once every node has
    run out. One host-side collective; every rank raises alike when a node
    has no batch at all, or when some nodes' batches carry labels and
    others' do not."""
    src = batch if batch is not None else like
    shape = tuple(src.nbr_idx.shape) if src is not None else (0, 0, 0)
    labeled = src is not None and src.y is not None
    has, none, rows, nodes, nbrs, yes, no = mesh.max(
        [int(batch is not None), int(src is None), *shape, int(labeled),
         int(src is not None and not labeled)])
    if not has:
        return None
    if none:
        raise ValueError("a node has no training batch: every node needs one an epoch")
    if yes and no:
        raise ValueError("some nodes' training batches carry labels and others' do not")
    if batch is None:
        src = src.replace(node_mask=torch.zeros_like(src.node_mask),
                          nbr_mask=torch.zeros_like(src.nbr_mask))
    src = _fill_rows(src, rows - shape[0])
    grown = {}
    for f in _GRAPH:
        t = getattr(src, f)
        if t is None:
            continue
        size = list(t.shape)
        if f != "y":
            size[1] = nodes
            if f in ("nbr_idx", "nbr_mask", "edge_attr"):
                size[2] = nbrs
        grown[f] = _grow(t, size)
    return src.replace(**grown)


def replicate_tree(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast each tensor from rank 0, in place (the parameters at init
    and the whole training state after a restore)."""
    if mesh.group is None:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)


__all__ = ["DATA_AXIS", "Mesh", "align_node_batches", "check_axes", "local_world_size",
           "make_mesh", "pad_batch_to_devices", "replicate_tree", "shard_batch", "shard_rows"]
