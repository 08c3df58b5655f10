"""The mesh over ``torch.distributed`` ranks and its collectives
(counterpart of the JAX package's ``parallel/mesh.py``).

A ``Mesh`` names its axes and their sizes, as a JAX mesh does, and orders
the ranks row-major over its shape, as JAX reshapes its device list: with
axes ``(data, model)`` and shape ``(dp, tp)`` rank ``r`` sits at data index
``r // tp`` and model index ``r % tp``. Every rank holds one ``Axis`` per
axis: the line of ranks that differ from it only in that axis's index, its
process group (one ``dist.new_group`` per line, made on every rank in the
same order) and its own index on it.

The ``data`` axis shards the batch: each rank takes a contiguous block of
rows of every global batch (data index ``d`` of ``D`` takes rows
``[d·B/D, (d+1)·B/D)``, the order in which JAX lays a batch over its
devices). The ranks of one line of the other axes step on the same rows.
``Mesh.size``, ``Mesh.rank`` and ``Mesh.group`` are the ``data`` axis's.
A mesh of one rank needs no process group: the trainer then runs its
single-process path.

A node is a block of ``LOCAL_WORLD_SIZE`` consecutive ranks (as torchrun and
the train CLI set it; every rank when unset), the counterpart of a JAX
process; with the ``data`` axis leading, a node holds whole lines of the
other axes. Each node loads its own training batches; its data ranks split
each of them (``shard_batch(..., node=True)``), so the global batch is the
nodes' batches stacked in node order and data index ``d`` still holds
global rows ``[d·b, (d+1)·b)``. Over several nodes ``align_node_batches``
brings every rank's rows to one shape before a step.

Each collective of an ``Axis`` takes one of three routes, named by
``Axis.route(tensor)``:

* ``nccl``: the native collective (one card a rank);
* ``gloo``: the native collective on CPU tensors (gloo runs all of them
  there);
* ``gloo-cuda:all_reduce``: gloo on CUDA tensors runs only ``all_reduce``
  and ``broadcast``, so ``all_gather``, ``all_to_all`` and the pipeline's
  shift are built from one ``all_reduce`` over a zero-filled buffer that
  holds every rank's part in its own slot (adding zeros leaves every value
  exact). This is the route of ranks that share one card.

No route falls back to a replicated computation: a mesh whose shape does
not match the process group raises. Host-side agreement (the preemption
flag) goes over a gloo group of its own, so it needs no device sync.

The module's collectives with a gradient come in two adjoint conventions,
named where they are defined: ``all_reduce``, ``all_gather``,
``all_to_all`` and ``shift`` for a loss summed over ranks, and
``copy_to_line``, ``reduce_from_line``, ``gather_from_line`` and
``scatter_to_line`` for a loss that every rank of a line holds (the
tensor- and expert-parallel layers).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.graph import PaddedGraph

DATA_AXIS = "data"
MODEL_AXIS = "model"
_GRAPH = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")


class Axis:
    """One axis of a mesh seen from this rank: ``size`` ranks (``ranks``,
    global ranks in index order) over ``group`` (None: one rank, or no
    process group), this rank at ``index``. The collectives below are raw
    (no gradient); each is a no-op on an axis of one rank."""

    def __init__(self, name: str, size: int = 1, index: int = 0, group: Any = None,
                 ranks: Sequence[int] = (0,)):
        self.name, self.size, self.index = name, int(size), int(index)
        self.group, self.ranks = group, tuple(ranks)

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index}, ranks={self.ranks})"

    def route(self, t: torch.Tensor) -> str:
        """``local``, ``nccl``, ``gloo`` or ``gloo-cuda:all_reduce`` (see the
        module note) for collectives on ``t``."""
        if self.group is None or self.size == 1:
            return "local"
        backend = str(dist.get_backend(self.group))
        if backend == "gloo" and t.is_cuda:
            return "gloo-cuda:all_reduce"
        return backend

    def _summed(self, t: torch.Tensor) -> bool:
        """Whether collectives on ``t`` are built from an all-reduce."""
        return self.route(t) == "gloo-cuda:all_reduce"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, index: int = 0) -> torch.Tensor:
        """``t`` of the rank at ``index`` on every rank of the axis, in place."""
        if self.size > 1:
            dist.broadcast(t, src=self.ranks[index], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        index order."""
        if self.size == 1:
            return t
        dim = dim % t.dim()
        if self._summed(t):
            n = t.shape[dim]
            shape = list(t.shape)
            shape[dim] = n * self.size
            buf = t.new_zeros(shape)
            buf.narrow(dim, self.index * n, n).copy_(t)
            return self.all_reduce_(buf)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def all_to_all(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Split ``dim`` into ``size`` equal chunks, send chunk ``j`` to the
        rank at index ``j``; returns the chunks received, concatenated along
        ``dim`` in the senders' index order."""
        if self.size == 1:
            return t
        dim = dim % t.dim()
        if t.shape[dim] % self.size:
            raise ValueError(f"all_to_all: dim {dim} of {tuple(t.shape)} does not split "
                             f"into {self.size}")
        c = t.shape[dim] // self.size
        if self._summed(t):
            buf = t.new_zeros((self.size,) + tuple(t.shape))      # [sender, ...]
            buf[self.index] = t
            self.all_reduce_(buf)
            mine = buf.narrow(dim + 1, self.index * c, c)         # [sender, ..., c, ...]
            return mine.movedim(0, dim).flatten(dim, dim + 1)
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """Send ``t`` to the rank ``offset`` indices ahead (cyclically) and
        return what the rank ``offset`` behind sent."""
        if self.size == 1:
            return t
        to = (self.index + offset) % self.size
        frm = (self.index - offset) % self.size
        if self._summed(t):
            buf = t.new_zeros((self.size,) + tuple(t.shape))
            buf[to] = t
            return self.all_reduce_(buf)[self.index]
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, self.ranks[to], self.group),
               dist.P2POp(dist.irecv, out, self.ranks[frm], self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


# ---------------------------------------------------------------------------
# Collectives with a gradient, in two adjoint conventions:
#
# * summed loss (``all_reduce``, ``all_gather``, ``all_to_all``, ``shift``):
#   each rank holds its part of a loss that is the sum over ranks, so a
#   collective's gradient is its exact adjoint: a sum is summed back, a
#   gather summed and cut, an exchange or a shift sent back;
# * replicated loss (``copy_to_line``, ``reduce_from_line``,
#   ``gather_from_line``, ``scatter_to_line``): every rank of the line holds
#   the same activations and the same loss, counted once (the tensor- and
#   expert-parallel layers), so the collectives come in conjugate pairs:
#   a copy's gradient is summed and a sum's passes on; a gather's gradient
#   is cut and a cut's gathered.
# ---------------------------------------------------------------------------

class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, summed_loss):
        ctx.axis, ctx.summed_loss = axis, summed_loss
        return axis.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed_loss:
            grad = ctx.axis.all_reduce_(grad.contiguous().clone())
        return grad, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, summed_loss):
        ctx.axis, ctx.dim, ctx.n, ctx.summed_loss = axis, dim % x.dim(), x.shape[dim], summed_loss
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed_loss:
            grad = ctx.axis.all_reduce_(grad.contiguous().clone())
        part = grad.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n).contiguous()
        return part, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_to_all(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_to_all(grad.contiguous(), ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return axis.shift(x, offset)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.shift(grad.contiguous(), -ctx.offset), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.contiguous().clone()), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_gather(grad.contiguous(), ctx.dim), None, None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its gradient is summed back (summed
    loss)."""
    return x if axis.size == 1 else _Sum.apply(x, axis, True)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in index order; the
    gradient is summed over the axis and each rank keeps its own part
    (summed loss)."""
    if axis.size == 1:
        return x
    if x.dtype == torch.bool:
        return _Gather.apply(x.float(), axis, dim, True) > 0.5
    return _Gather.apply(x, axis, dim, True)


def all_to_all(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """``Axis.all_to_all`` with a gradient: the incoming gradient is sent
    back the way the values came."""
    return x if axis.size == 1 else _AllToAll.apply(x, axis, dim)


def shift(x: torch.Tensor, axis: Axis, offset: int = 1) -> torch.Tensor:
    """``Axis.shift`` with a gradient (summed loss): the rank ``offset``
    indices behind's ``x`` (cyclically); the incoming gradient goes back the
    way the values came, shifted by ``-offset``. The identity on a line of
    one rank."""
    return x if axis.size == 1 else _Shift.apply(x, axis, offset)


def copy_to_line(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axis`` (a replicated input
    that each rank uses for its part of the work; replicated loss)."""
    return x if axis.size == 1 else _Copy.apply(x, axis)


def reduce_from_line(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of each rank's part over ``axis``; the gradient passes on
    (replicated loss: the sum is one value every rank holds)."""
    return x if axis.size == 1 else _Sum.apply(x, axis, False)


def gather_from_line(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """Every rank's part concatenated along ``dim``; the gradient is cut to
    this rank's part (replicated loss)."""
    return x if axis.size == 1 else _Gather.apply(x, axis, dim, False)


def scatter_to_line(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated ``x``; the gradient is
    gathered back whole (replicated loss)."""
    return x if axis.size == 1 else _Scatter.apply(x, axis, dim)


@dataclass
class Mesh:
    """Named axes over the ranks of a process group; ``lines`` maps each
    axis to this rank's ``Axis`` (empty: one process, no collectives)."""

    axes: tuple
    shape: tuple
    lines: Dict[str, Axis] = field(default_factory=dict)
    control: Any = None      # a gloo group for host-side flags
    local: int = 1           # data ranks a node
    world: Optional[Axis] = None    # every rank, for the broadcast at init

    def axis(self, name: str) -> Axis:
        """This rank's line along ``name`` (size 1 when the mesh has no such
        axis)."""
        if name in self.lines:
            return self.lines[name]
        size = self.shape[self.axes.index(name)] if name in self.axes else 1
        if size > 1:
            raise ValueError(f"the mesh axis {name!r} of size {size} has no process group")
        return Axis(name)

    @property
    def group(self) -> Any:
        return self.axis(DATA_AXIS).group

    @property
    def size(self) -> int:
        return self.shape[self.axes.index(DATA_AXIS)]

    @property
    def rank(self) -> int:
        return self.axis(DATA_AXIS).index

    @property
    def world_rank(self) -> int:
        return dist.get_rank() if self.world is not None else 0

    @property
    def nodes(self) -> int:
        return self.size // self.local

    @property
    def local_rank(self) -> int:
        return self.rank % self.local

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ``data`` axis, in place."""
        return self.axis(DATA_AXIS).all_reduce_(tensor)

    def sum_grads(self, grads: Sequence[torch.Tensor], values: torch.Tensor) -> torch.Tensor:
        """Sum ``grads`` (in place) and the vector ``values`` over the
        ``data`` axis in one all-reduce; returns the summed ``values``."""
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads] + [values]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def max(self, values: Sequence[int]) -> list:
        """The largest of each of ``values`` over every rank (host-side)."""
        t = torch.tensor(list(values), dtype=torch.int64)
        if self.control is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return t.tolist()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a host-side collective)."""
        return bool(self.max([int(flag)])[0])

    def mean(self, num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global batch mean: ``num / max(count over
        every data rank, 1)``; the shares of all data ranks sum to the mean."""
        total = self.all_reduce(count.detach().float().clone())
        return num / total.clamp_min(1.0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` stacked along dim 0 in index order (equal
        shapes on every rank), with a gradient: the backward sums the
        incoming gradient over the data ranks and keeps this rank's rows."""
        return all_gather(x, self.axis(DATA_AXIS), 0)


def check_axes(axes: Sequence[str], shape: Sequence[int]) -> None:
    """Equal lengths, distinct names, sizes of at least 1 and a ``data``
    axis."""
    if len(axes) != len(shape):
        raise ValueError(f"mesh axes {tuple(axes)} and shape {tuple(shape)} differ in length")
    if DATA_AXIS not in axes:
        raise ValueError(f"a mesh needs a {DATA_AXIS!r} axis, got {tuple(axes)}")
    if len(set(axes)) != len(axes) or any(int(s) < 1 for s in shape):
        raise ValueError(f"mesh axes {tuple(axes)} must be distinct and sizes {tuple(shape)} "
                         f"at least 1")


def local_world_size(world: int) -> int:
    """Ranks a node: ``LOCAL_WORLD_SIZE``, else all ``world`` of them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _lines(axes: tuple, shape: tuple, rank: int, world_group: Any) -> Dict[str, Axis]:
    """This rank's line along every axis of more than one rank (in a world
    of one rank, along every axis: the ``data`` line then marks the
    data-parallel path, as before this module had other axes). Every rank
    makes every line's group, in the same order (``dist.new_group`` is
    collective); a line that spans the world takes the world group."""
    world = math.prod(shape)
    coords = []
    r = rank
    for size in reversed(shape):
        coords.append(r % size)
        r //= size
    coords = coords[::-1]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    lines = {}
    for a, (name, size) in enumerate(zip(axes, shape)):
        if size == 1 and world > 1:
            continue
        others = [range(s) if i != a else range(1) for i, s in enumerate(shape)]
        mine = None
        for start in _product(others):
            base = sum(c * st for c, st in zip(start, strides))
            ranks = [base + j * strides[a] for j in range(size)]
            group = world_group if size == world else dist.new_group(ranks)
            if rank in ranks:
                mine = Axis(name, size, coords[a], group, ranks)
        lines[name] = mine
    return lines


def _product(ranges) -> Iterable[tuple]:
    """Row-major tuples over ``ranges``."""
    if not ranges:
        yield ()
        return
    for head in ranges[0]:
        for tail in _product(ranges[1:]):
            yield (head,) + tail


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks of the initialized default process group (or
    over one process when none is). Default: a 1-D ``data`` mesh over
    every rank (``n_devices`` of them when given). A mesh of more than one
    rank needs a process group of exactly ``prod(shape)`` ranks, in nodes
    of ``local_world_size`` ranks that hold whole lines of the axes after
    ``data``."""
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
    replicas = world // shape[axes.index(DATA_AXIS)]
    local = local_world_size(world)
    if local < 1 or world % local or local % replicas:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not split the world of {world} ranks "
                         f"into nodes of whole lines of {replicas} ranks")
    rank = dist.get_rank()
    lines = _lines(axes, shape, rank, dist.group.WORLD)
    control = (dist.group.WORLD if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo"))
    return Mesh(axes, shape, lines, control, local // replicas,
                Axis("world", world, rank, dist.group.WORLD, range(world)))


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


def replicate_tree(tensors: Iterable[torch.Tensor], mesh: Mesh, axis: str = DATA_AXIS
                  ) -> None:
    """Broadcast each tensor from the first rank of this rank's line along
    ``axis`` (``"world"``: from rank 0 to every rank), in place: the
    parameters at init and the whole training state after a restore."""
    line = mesh.world if axis == "world" else mesh.axis(axis)
    if line is None:
        return
    for t in tensors:
        line.broadcast_(t.data, 0)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Axis", "Mesh", "align_node_batches", "all_gather",
           "all_reduce", "all_to_all", "check_axes", "copy_to_line", "gather_from_line",
           "local_world_size", "make_mesh", "pad_batch_to_devices", "reduce_from_line",
           "replicate_tree", "scatter_to_line", "shard_batch", "shard_rows", "shift"]
