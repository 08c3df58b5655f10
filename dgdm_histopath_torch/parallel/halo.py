"""Locality-aware halo exchange for node-sharded graphs (counterpart of the
JAX package's ``parallel/halo.py``).

1. **Spatial sort** (host, once per graph): nodes in Morton (Z-curve)
   order, so that a contiguous block of nodes is a compact region and most
   kNN edges stay inside their block (``ops.graph.morton_keys``).
2. **Halo plan** (host, once per batch): for every (source block j,
   destination block i) pair, the unique rows of j that i's nodes reference,
   padded to a static ``halo_size`` H, and each block's neighbour indices
   relabelled into its ``[local rows || halo buffer]`` coordinates. The
   host functions agree with the JAX package's bit for bit.
3. **Exchange** (device): a rank gathers its outgoing rows ``[b, tp, H,
   F]`` from its ``n_loc`` local rows, one ``all_to_all`` over its
   ``model`` line swaps them, and the neighbour gather runs locally against
   ``concat([x_local, halo])``, a table of ``n_loc + tp·H`` rows for
   ``n_loc`` query rows. Both gathers are the ``gather_rows`` kernel with a
   rectangular source on CUDA tensors (its plain version on CPU ones);
   ``sp_graph_conv``'s message sum is ``weighted_gather_sum`` over the same
   table. Like the JAX tier it is forward only.

A rank passes its own block (``parallel.sp.shard_graph_nodes``); the plan
is the whole batch's, and each rank reads its part of it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.graph import PaddedGraph, morton_keys
from ..ops.kernels.gather_agg import weighted_gather_sum
from ..ops.kernels.gather_rows import gather_rows
from .mesh import MODEL_AXIS, Axis, Mesh


# ---------------------------------------------------------------------------
# 1. spatial (Morton) sort: host-side, once per graph
# ---------------------------------------------------------------------------

def spatial_permutation(pos, node_mask) -> np.ndarray:
    """Permutation ``perm`` (new row i takes old row ``perm[i]``) putting real
    nodes in Morton order, padding last; stable, so deterministic."""
    return np.argsort(morton_keys(np.asarray(pos), np.asarray(node_mask)),
                      kind="stable").astype(np.int32)


def permute_graph(graph: PaddedGraph, perm) -> PaddedGraph:
    """Relabel an UNBATCHED graph by a node permutation: every per-node row
    moves together and neighbour ids are remapped through the inverse, so a
    mask-correct padded op gives row-permuted outputs."""
    if graph.x.dim() != 2:
        raise ValueError("permute_graph expects an unbatched graph; permute "
                         "before batch_graphs (per-graph perms differ)")
    perm = np.asarray(perm, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    idx = graph.nbr_idx.numpy()
    mask = graph.nbr_mask.numpy()
    new_idx = inv[idx][perm]
    new_idx = np.where(mask[perm], new_idx, 0).astype(np.int32)
    p = torch.from_numpy(perm)
    return PaddedGraph(x=graph.x[p], pos=graph.pos[p], nbr_idx=torch.from_numpy(new_idx),
                       nbr_mask=graph.nbr_mask[p], edge_attr=graph.edge_attr[p],
                       node_mask=graph.node_mask[p], y=graph.y)


def spatial_sort(graph: PaddedGraph) -> PaddedGraph:
    """Morton-sort an unbatched graph's nodes (the step-1 entry point)."""
    return permute_graph(graph, spatial_permutation(graph.pos, graph.node_mask))


# ---------------------------------------------------------------------------
# 2. halo plan: host-side, once per batch
# ---------------------------------------------------------------------------

class HaloPlan(NamedTuple):
    """Static exchange schedule for one batched bucket shape.

    send_idx      [B, tp, tp, H] int32: send_idx[b, j, i] are the LOCAL row
                  ids block j ships to block i (padded with 0).
    nbr_idx_local [B, N, K] int32: neighbour ids in each owning block's
                  ``[0, n_local + tp*H)`` coordinates (local rows first,
                  then the received halo buffer in source-block order).
    halo_size     H. n_local = N // tp. tp = the model-axis size.
    """

    send_idx: np.ndarray
    nbr_idx_local: np.ndarray
    halo_size: int
    n_local: int
    tp: int


def build_halo_plan(nbr_idx, nbr_mask, tp: int, halo_size: Optional[int] = None) -> HaloPlan:
    """Plan the exchange for contiguous block sharding of the node axis.
    ``halo_size`` pins H (one H per node bucket keeps the shapes stable);
    default: the largest a (source, destination) pair needs. Raises if a
    pair needs more than H rows, or if the bucket does not divide by tp."""
    idx = np.asarray(nbr_idx)
    msk = np.asarray(nbr_mask, bool)
    unbatched = idx.ndim == 2
    if unbatched:
        idx, msk = idx[None], msk[None]
    b_sz, n, k = idx.shape
    if n % tp:
        raise ValueError(f"node bucket {n} not divisible by tp={tp}")
    n_loc = n // tp

    dst_shard = np.repeat(np.arange(tp), n_loc)
    needed = {}
    h_max = 1
    for b in range(b_sz):
        src_shard = idx[b] // n_loc
        cross = msk[b] & (src_shard != dst_shard[:, None])
        for i in range(tp):
            rows = idx[b, i * n_loc:(i + 1) * n_loc]
            crs = cross[i * n_loc:(i + 1) * n_loc]
            srcs = rows // n_loc
            for j in range(tp):
                uniq = np.unique(rows[crs & (srcs == j)])
                if uniq.size:
                    needed[(b, j, i)] = uniq
                    h_max = max(h_max, int(uniq.size))
    h = int(halo_size) if halo_size is not None else h_max
    if h_max > h:
        raise ValueError(f"halo_size={h} too small: batch needs {h_max}")

    send_idx = np.zeros((b_sz, tp, tp, h), np.int32)
    new_idx = np.where(msk, idx % n_loc, 0).astype(np.int32)
    for (b, j, i), uniq in needed.items():
        send_idx[b, j, i, :uniq.size] = (uniq % n_loc).astype(np.int32)
        lo, hi = i * n_loc, (i + 1) * n_loc
        blk = idx[b, lo:hi]
        hit = msk[b, lo:hi] & np.isin(blk, uniq)
        pos = np.searchsorted(uniq, blk[hit])
        new_idx[b, lo:hi][hit] = (n_loc + j * h + pos).astype(np.int32)
    if b_sz and unbatched:
        send_idx, new_idx = send_idx[0], new_idx[0]
    return HaloPlan(send_idx=send_idx, nbr_idx_local=new_idx, halo_size=h, n_local=n_loc,
                    tp=tp)


def halo_fraction(nbr_idx, nbr_mask, tp: int) -> float:
    """Fraction of real edges that cross a block boundary under contiguous
    block sharding (lower after ``spatial_sort``, so a smaller H)."""
    idx = np.asarray(nbr_idx)
    msk = np.asarray(nbr_mask, bool)
    if idx.ndim == 2:
        idx, msk = idx[None], msk[None]
    n = idx.shape[-2]
    n_loc = n // tp
    dst = np.repeat(np.arange(tp), n_loc)[None, :, None]
    cross = msk & ((idx // n_loc) != dst)
    total = max(int(msk.sum()), 1)
    return float(cross.sum()) / total


# ---------------------------------------------------------------------------
# 3. exchange + gather: device-side, on this rank's block
# ---------------------------------------------------------------------------

def _model_line(mesh: Mesh, plan: HaloPlan) -> Axis:
    if MODEL_AXIS not in mesh.axes:
        raise ValueError("the halo exchange needs a mesh with a 'model' axis")
    axis = mesh.axis(MODEL_AXIS)
    if axis.size != plan.tp:
        raise ValueError(f"plan built for tp={plan.tp}, mesh has {axis.size}")
    return axis


def local_plan(plan: HaloPlan, mesh: Mesh, batch_sharded: bool = True,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of ``plan`` (batched): ``send`` [b, tp, H], the local
    rows it ships to each block, and ``idx`` [b, n_local, K], its neighbour
    ids in ``[local || halo]`` coordinates; b is its data index's rows when
    ``batch_sharded``, else the whole batch."""
    axis = _model_line(mesh, plan)
    send = np.asarray(plan.send_idx)[:, axis.index]
    lo = axis.index * plan.n_local
    idx = np.asarray(plan.nbr_idx_local)[:, lo:lo + plan.n_local]
    if batch_sharded:
        n = send.shape[0] // mesh.size
        send, idx = (a[mesh.rank * n:(mesh.rank + 1) * n] for a in (send, idx))
    return (torch.from_numpy(np.ascontiguousarray(send)).to(device),
            torch.from_numpy(np.ascontiguousarray(idx)).to(device))


def halo_table(x: torch.Tensor, send: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[x_local || halo]``: the rows this rank ships (``send`` [b, tp, H],
    one rectangular gather from its ``n_loc`` rows), exchanged over ``axis``
    by one all-to-all, appended to its own rows -> [b, n_loc + tp·H, F]."""
    b, _, f = x.shape
    rows = gather_rows(x.contiguous(), send)               # [b, tp, H, F]
    recv = axis.all_to_all(rows, dim=1)                   # [b, tp (senders), H, F]
    return torch.cat([x, recv.reshape(b, -1, f)], dim=1).contiguous()


def halo_gather(x: torch.Tensor, plan: HaloPlan, mesh: Mesh,
                batch_sharded: bool = True) -> torch.Tensor:
    """Neighbour gather over this rank's node block ``x`` [b, n_loc, F] (or
    [n_loc, F] with an unbatched plan): ``[b, n_loc, K, F]``, equal to the
    dense gather's rows of this block on every real slot. One all-to-all of
    ``tp·H`` rows over the ``model`` line, per-rank traffic ``tp·H·F`` in
    place of the ``N·F`` of an all-gather."""
    axis = _model_line(mesh, plan)
    if x.dim() == 2:
        one = plan._replace(send_idx=np.asarray(plan.send_idx)[None],
                            nbr_idx_local=np.asarray(plan.nbr_idx_local)[None])
        return halo_gather(x[None], one, mesh, batch_sharded=False)[0]
    send, idx = local_plan(plan, mesh, batch_sharded, x.device)
    return gather_rows(halo_table(x, send, axis), idx)


def sp_graph_conv(conv, x: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                  plan: HaloPlan, mesh: Mesh, edge_attr: Optional[torch.Tensor] = None,
                  edge_weight: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32, batch_sharded: bool = True
                  ) -> torch.Tensor:
    """``nn.graph_layers.GraphConvolution`` (``conv``'s parameters) over this
    rank's node block: every per-node op local, the neighbours' inverse
    square-root degrees and features each taken over the one plan (both
    gathers index through ``nbr_idx``; ``nbr_idx`` itself, global ids, is
    read only through the plan), the edge term reassociated by linearity,
    the math of the JAX package's ``sp_graph_conv``. Inputs and output are
    this rank's ``[b, n_loc, ...]`` block."""
    axis = _model_line(mesh, plan)
    send, idx = local_plan(plan, mesh, batch_sharded, x.device)
    if nbr_idx.shape[:2] != idx.shape[:2]:
        raise ValueError(f"block {tuple(nbr_idx.shape)} does not match its plan part "
                         f"{tuple(idx.shape)}")
    mask = nbr_mask.to(dtype)
    h = F.linear(x.to(dtype), conv.lin.weight.to(dtype))      # node-local
    deg = mask.sum(-1) + 1.0                                   # the self-loop
    inv = torch.rsqrt(deg.clamp_min(1.0))                       # [b, n_loc]
    nbr_inv = gather_rows(halo_table(inv[..., None].contiguous(), send, axis), idx)[..., 0]
    weight = inv[..., None] * nbr_inv * mask
    if edge_weight is not None:
        weight = weight * edge_weight.to(dtype)
    weight = weight * mask
    agg = weighted_gather_sum(halo_table(h, send, axis), idx,
                              weight.float().contiguous()).to(dtype)
    if edge_attr is not None and conv.edge_lin is not None:
        e_sum = (edge_attr.to(dtype) * weight[..., None]).sum(-2)
        agg = agg + F.linear(e_sum, conv.edge_lin.weight.to(dtype))
    out = agg + h * (inv * inv)[..., None]
    return out + conv.bias.to(dtype)


__all__ = ["HaloPlan", "build_halo_plan", "halo_fraction", "halo_gather", "halo_table",
           "local_plan", "morton_keys", "permute_graph", "sp_graph_conv", "spatial_permutation",
           "spatial_sort"]
