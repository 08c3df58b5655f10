"""Padded dense-neighbor graph format and masked segment ops.

A tissue graph is stored as fixed-size padded tensors (the layout of the
JAX package's ``ops/graph.py``):

  - ``x``         [N, F]    node (patch) features
  - ``pos``       [N, 2]    normalized patch coordinates
  - ``nbr_idx``   [N, K]    int32 neighbor indices (row i's incoming edges)
  - ``nbr_mask``  [N, K]    True where the neighbor slot is a real edge
  - ``edge_attr`` [N, K, E] per-edge features (dist/weight/sim)
  - ``node_mask`` [N]       True for real (non-padding) nodes

A batch adds a leading ``B`` axis to every field. The model's ops take the
batched form; ``N`` comes from a small set of buckets.

The neighbor row gather is the ``gather_rows`` CUDA kernel on the card and
its plain PyTorch version on the CPU (``ops/kernels/gather_rows.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels.gather_rows import gather_rows, index_in_range
from .kernels.neighbor_transpose import NeighborTranspose

_FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")


@dataclasses.dataclass
class PaddedGraph:
    """A fixed-shape tissue graph (or batch of graphs with leading axis)."""

    x: torch.Tensor          # [..., N, F] float
    pos: torch.Tensor        # [..., N, 2] float
    nbr_idx: torch.Tensor    # [..., N, K] int32
    nbr_mask: torch.Tensor   # [..., N, K] bool
    edge_attr: torch.Tensor  # [..., N, K, E] float
    node_mask: torch.Tensor  # [..., N] bool
    y: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def max_neighbors(self) -> int:
        return self.nbr_idx.shape[-1]

    @property
    def feature_dim(self) -> int:
        return self.x.shape[-1]

    def replace(self, **changes) -> "PaddedGraph":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "PaddedGraph":
        return self.replace(**{f: getattr(self, f).to(device, non_blocking=non_blocking)
                               for f in _FIELDS if getattr(self, f) is not None})

    def pin_memory(self) -> "PaddedGraph":
        """A copy in page-locked host memory (the source of an asynchronous upload)."""
        return self.replace(**{f: getattr(self, f).pin_memory() for f in _FIELDS
                               if getattr(self, f) is not None})

    def tensors(self) -> list:
        return [getattr(self, f) for f in _FIELDS if getattr(self, f) is not None]

    def unsqueeze(self) -> "PaddedGraph":
        """Add a leading batch axis of 1 to every field."""
        return self.replace(**{f: getattr(self, f)[None] for f in _FIELDS
                               if getattr(self, f) is not None})


# a pytree, so that torch.export takes a PaddedGraph argument as it is
# (``deployment/edge.py::EdgeModelOptimizer.export_stablehlo``), and a type
# that a weights-only load of a saved program's example inputs accepts
torch.export.register_dataclass(PaddedGraph,
                                serialized_type_name="dgdm_histopath_torch.PaddedGraph")
torch.serialization.add_safe_globals([PaddedGraph])


def gather_neighbors(x: torch.Tensor, nbr_idx: torch.Tensor,
                     nbr_t: Optional[NeighborTranspose] = None) -> torch.Tensor:
    """Gather neighbor rows: x [B, N, F], nbr_idx [B, N, K] -> [B, N, K, F].

    An index outside [0, N) gives a zero row. ``nbr_t``: nbr_idx's
    transposed list for the backward, where the caller has it."""
    return gather_rows(x, nbr_idx, nbr_t)


def real_edge_index(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """``nbr_idx`` with every masked-off slot set to -1, outside [0, N).

    Padding rows and the edges that pooling drops keep index 0 in the padded
    format, so node 0 would collect thousands of slots in a backward. They
    carry zero weight in every layer (the per-edge softmax, the degree
    normalization and the message weights all read the mask), and a gather
    treats an index outside [0, N) as a zero row that adds nothing: pointing
    them outside changes no forward value, and their zero cotangents are no
    longer summed into node 0."""
    return torch.where(nbr_mask, nbr_idx, torch.full_like(nbr_idx, -1))


def gather_scalar(values: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Gather per-node scalars: values [..., N], nbr_idx [..., N, K] -> [..., N, K].

    An index outside [0, N) gives 0, as in :func:`gather_neighbors`."""
    *batch, n = values.shape
    k = nbr_idx.shape[-1]
    valid, safe = index_in_range(nbr_idx.reshape(*batch, n * k), n)
    flat = torch.gather(values, -1, safe) * valid.to(values.dtype)
    return flat.reshape(*batch, n, k)


def masked_neighbor_sum(messages: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """Sum messages [..., N, K, F] over the valid neighbor slots -> [..., N, F]."""
    return (messages * nbr_mask[..., None].to(messages.dtype)).sum(-2)


def masked_neighbor_mean(messages: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """Mean of messages [..., N, K, F] over the valid slots; a row without
    one gives zeros."""
    count = nbr_mask.to(messages.dtype).sum(-1, keepdim=True)
    return masked_neighbor_sum(messages, nbr_mask) / count.clamp_min(1.0)


def degrees(nbr_mask: torch.Tensor, add_self_loops: bool = True) -> torch.Tensor:
    """In-degree per node from the neighbor mask; [..., N] f32."""
    deg = nbr_mask.float().sum(-1)
    if add_self_loops:
        deg = deg + 1.0
    return deg


def symmetric_norm(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GCN symmetric normalization 1/sqrt(d_i d_j) per neighbor slot.

    Returns (edge_norm [..., N, K], self_norm [..., N]), both f32.
    """
    deg = degrees(nbr_mask, add_self_loops=True)
    inv_sqrt = torch.rsqrt(deg.clamp_min(1.0))
    nbr_inv = gather_scalar(inv_sqrt, nbr_idx)
    edge_norm = inv_sqrt[..., :, None] * nbr_inv * nbr_mask.to(inv_sqrt.dtype)
    return edge_norm, inv_sqrt * inv_sqrt


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1
                   ) -> torch.Tensor:
    """Numerically-stable softmax that zeroes masked entries.

    Fully-masked rows return all-zeros rather than NaN, but for f16 logits:
    the floor 1e-20 is taken in the logits' dtype, as in the reference
    (``jnp.asarray(1e-20, unnorm.dtype)``), and is 0 in f16, so such a row is
    0 / 0 = NaN there. Every caller in the model passes f32 logits.
    """
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, torch.full_like(logits, neg))
    maxes = masked.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(masked - maxes) * mask.to(logits.dtype)
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / torch.maximum(denom, denom.new_tensor(1e-20))


# ---------------------------------------------------------------------------
# Banded (Morton-window) message passing
#
# With nodes in spatial-sort (Morton) order cut into nb = N/W contiguous
# blocks, a node of block b may address neighbors in blocks [b-1, b+1], the
# band that windowed SpatialAttention uses too. Neighbor slots outside the
# band are masked off, also in the degree normalization, so a banded layer
# computes exactly the dense layer on the band-pruned graph. On the TPU the
# band shrinks the one-hot adjacency to [nb, W, 3W]; the gather kernels need
# no such layout, so here the band is only this mask on absolute indices.
# ---------------------------------------------------------------------------

def band_eligible(n: int, window: Optional[int]) -> bool:
    """The band applies when the bucket splits into >= 3 whole blocks."""
    return window is not None and window > 0 and n % window == 0 and n // window >= 3


def in_band_mask(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor, window: int) -> torch.Tensor:
    """``nbr_mask`` [..., N, K] with the out-of-band slots masked off.

    Node i of block b = i // W reaches the nodes [(b-1)·W, (b+2)·W), clipped
    to the bucket (the band does not wrap around its ends); a neighbor
    outside it is dropped.
    """
    n = nbr_idx.shape[-2]
    base = (torch.arange(n, device=nbr_idx.device, dtype=nbr_idx.dtype) // window - 1) * window
    rel = nbr_idx - base[:, None]
    return (rel >= 0) & (rel < 3 * window) & nbr_mask


def band_prune(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """``nbr_mask`` with the out-of-band slots masked off where the band
    applies to this bucket, else as it is."""
    if not band_eligible(nbr_idx.shape[-2], window):
        return nbr_mask
    return in_band_mask(nbr_idx, nbr_mask, window)


def in_band_fraction(nbr_idx, nbr_mask, window: int) -> float:
    """Host diagnostic: the fraction of real edges a banded model can address
    (1.0: banded compute is exact on this graph)."""
    idx = torch.as_tensor(nbr_idx)
    mask = torch.as_tensor(nbr_mask, dtype=torch.bool, device=idx.device)
    return float(in_band_mask(idx, mask, window).sum()) / max(int(mask.sum()), 1)


def compact_top_k_nodes(
    x: torch.Tensor,          # [B, N, F]
    nbr_idx: torch.Tensor,    # [B, N, K]
    nbr_mask: torch.Tensor,   # [B, N, K]
    node_mask: torch.Tensor,  # [B, N]
    score: torch.Tensor,      # [B, N], higher = keep
    keep: int,
    edge_attr: Optional[torch.Tensor] = None,   # [B, N, K, E]
) -> dict:
    """Physically shrink a padded graph to its top-``keep`` nodes.

    Returns a dict with compacted ``x, nbr_idx, nbr_mask, node_mask,
    edge_attr`` and ``sel_idx [B, keep]`` (original node ids, for
    :func:`scatter_nodes` unpooling). Edges into dropped nodes, or to an
    index outside [0, N), are removed; padding/dropped slots select node 0
    with ``node_mask`` False.

    The selection is a stable descending sort, so equal scores keep the
    lower node index first, as ``jnp.argsort`` does in the JAX package.
    """
    neg = torch.finfo(torch.float32).min
    masked_score = torch.where(node_mask, score.float(),
                               torch.full_like(score, neg, dtype=torch.float32))
    sel_idx = torch.argsort(-masked_score, dim=-1, stable=True)[..., :keep]
    sel_valid = torch.gather(node_mask, -1, sel_idx)

    # inverse map: orig id -> compact slot, `keep` where dropped
    slots = torch.arange(keep, device=x.device).expand_as(sel_idx)
    inv = torch.full(node_mask.shape, keep, dtype=torch.long, device=x.device)
    inv.scatter_(-1, sel_idx, slots)

    k = nbr_idx.shape[-1]
    row_sel = sel_idx[..., None].expand(*sel_idx.shape, k)
    nbr_rows = torch.gather(nbr_idx, -2, row_sel)                 # [B, keep, K]
    mask_rows = torch.gather(nbr_mask, -2, row_sel)
    in_range, nbr_rows = index_in_range(nbr_rows, node_mask.shape[-1])
    new_ids = torch.gather(inv, -1, nbr_rows.flatten(-2)).reshape(nbr_rows.shape)
    new_mask = mask_rows & in_range & (new_ids < keep) & sel_valid[..., None]
    new_ids = torch.where(new_mask, new_ids, 0).to(nbr_idx.dtype)

    x_c = torch.gather(x, -2, sel_idx[..., None].expand(*sel_idx.shape, x.shape[-1]))
    x_c = x_c * sel_valid[..., None].to(x.dtype)
    out = {"x": x_c, "nbr_idx": new_ids, "nbr_mask": new_mask,
           "node_mask": sel_valid, "sel_idx": sel_idx, "edge_attr": None}
    if edge_attr is not None:
        e = edge_attr.shape[-1]
        ea_rows = torch.gather(edge_attr, -3,
                               row_sel[..., None].expand(*row_sel.shape, e))
        out["edge_attr"] = ea_rows * new_mask[..., None].to(ea_rows.dtype)
    return out


def scatter_nodes(h_small: torch.Tensor, sel_idx: torch.Tensor, n: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unpool: place compacted rows back at their original slots, zeros
    elsewhere. h_small [B, keep, F], sel_idx [B, keep] -> [B, n, F]."""
    if valid is not None:
        h_small = h_small * valid[..., None].to(h_small.dtype)
    out = h_small.new_zeros(*h_small.shape[:-2], n, h_small.shape[-1])
    return out.scatter(-2, sel_idx[..., None].expand_as(h_small), h_small)


def masked_global_mean(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Mean over real nodes: x [..., N, F], mask [..., N] -> [..., F]."""
    m = node_mask.to(x.dtype)[..., None]
    total = (x * m).sum(-2)
    count = m.sum(-2).clamp_min(1.0)
    return total / count


def masked_global_max(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    neg = torch.finfo(x.dtype).min
    return torch.where(node_mask[..., None], x, torch.full_like(x, neg)).amax(-2)


# ---------------------------------------------------------------------------
# Construction helpers (host-side, numpy in, CPU tensors out)
# ---------------------------------------------------------------------------

def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if n exceeds all; caller subsamples)."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1])


def build_padded_graph(
    x: np.ndarray,
    pos: np.ndarray,
    nbr_idx: np.ndarray,
    nbr_dist_or_attr: np.ndarray,
    nbr_mask: np.ndarray,
    bucket: Optional[int] = None,
    y: Optional[np.ndarray] = None,
) -> PaddedGraph:
    """Pad host-side graph arrays up to ``bucket`` nodes (CPU tensors)."""
    n, _ = x.shape
    k = nbr_idx.shape[1]
    e = nbr_dist_or_attr.shape[-1] if nbr_dist_or_attr.ndim == 3 else 1
    attr = nbr_dist_or_attr.reshape(n, k, e)
    target = int(bucket) if bucket is not None else n
    if n > target:
        raise ValueError(f"graph has {n} nodes, exceeds bucket {target}")
    pad = target - n
    node_mask = np.zeros((target,), dtype=bool)
    node_mask[:n] = True
    t = torch.from_numpy
    return PaddedGraph(
        x=t(np.pad(x.astype(np.float32), ((0, pad), (0, 0)))),
        pos=t(np.pad(pos.astype(np.float32), ((0, pad), (0, 0)))),
        nbr_idx=t(np.pad(nbr_idx.astype(np.int32), ((0, pad), (0, 0)))),
        nbr_mask=t(np.pad(nbr_mask.astype(bool), ((0, pad), (0, 0)))),
        edge_attr=t(np.pad(attr.astype(np.float32), ((0, pad), (0, 0), (0, 0)))),
        node_mask=t(node_mask),
        y=None if y is None else torch.as_tensor(y),
    )


def from_edge_index(
    x: np.ndarray,
    edge_index: np.ndarray,
    pos: Optional[np.ndarray] = None,
    edge_attr: Optional[np.ndarray] = None,
    max_neighbors: int = 16,
    bucket: Optional[int] = None,
    y: Optional[np.ndarray] = None,
) -> PaddedGraph:
    """A COO edge list ``edge_index`` [2, E] of (src, dst) rows -> PaddedGraph.

    Node i's incoming edges (dst == i) fill its slots, at most
    ``max_neighbors``: highest weight first where ``edge_attr`` is given
    (the weight is its last column), else in input order.
    """
    n = x.shape[0]
    e_dim = 1 if edge_attr is None else (edge_attr.shape[1] if edge_attr.ndim == 2 else 1)
    nbr_idx = np.zeros((n, max_neighbors), dtype=np.int32)
    nbr_mask = np.zeros((n, max_neighbors), dtype=bool)
    attr = np.zeros((n, max_neighbors, e_dim), dtype=np.float32)
    if edge_index.size:
        src, dst = edge_index[0], edge_index[1]
        n_edges = src.shape[0]
        ea = None
        if edge_attr is not None and edge_attr.shape[0] == n_edges:
            ea = edge_attr.reshape(n_edges, -1)
        if ea is not None:
            order = np.lexsort((-ea[:, -1], dst))      # dst ascending, weight descending
        else:
            order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        if ea is not None:
            ea = ea[order]
        # each edge's rank within its dst group is its slot
        starts = np.searchsorted(dst, np.arange(n), side="left")
        rank = np.arange(n_edges) - starts[dst]
        keep = rank < max_neighbors
        d_k, r_k = dst[keep], rank[keep]
        nbr_idx[d_k, r_k] = src[keep]
        nbr_mask[d_k, r_k] = True
        if ea is not None:
            attr[d_k, r_k, : ea.shape[1]] = ea[keep]
    if pos is None:
        pos = np.zeros((n, 2), dtype=np.float32)
    return build_padded_graph(x, pos, nbr_idx, attr, nbr_mask, bucket=bucket, y=y)


def _interleave_bits(v: np.ndarray) -> np.ndarray:
    """Spread each of the low 16 bits of ``v`` to even positions (int64)."""
    v = v.astype(np.int64) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_keys(pos: np.ndarray, node_mask: np.ndarray) -> np.ndarray:
    """Z-curve key per node from its 2-D coordinates, quantised to 16 bits
    over the real nodes' extent; padding rows get the largest key, so they
    sort last. pos [N, 2] -> int64 [N]."""
    pos = np.asarray(pos, np.float64)
    mask = np.asarray(node_mask, bool)
    if mask.any():
        lo = pos[mask].min(axis=0)
        span = np.maximum(pos[mask].max(axis=0) - lo, 1e-12)
    else:
        lo, span = np.zeros(2), np.ones(2)
    q = np.clip(((pos - lo) / span * 65535.0), 0, 65535).astype(np.int64)
    keys = _interleave_bits(q[:, 0]) | (_interleave_bits(q[:, 1]) << 1)
    return np.where(mask, keys, np.iinfo(np.int64).max)


def batch_graphs(graphs: Sequence[PaddedGraph]) -> PaddedGraph:
    """Stack same-bucket graphs into a batched PaddedGraph (leading B axis)."""
    if not graphs:
        raise ValueError("cannot batch zero graphs")
    n = graphs[0].num_nodes
    k = graphs[0].max_neighbors
    for g in graphs:
        if g.num_nodes != n or g.max_neighbors != k:
            raise ValueError("all graphs in a batch must share the same bucket shape")
    ys = [g.y for g in graphs]
    fields = {f: torch.stack([getattr(g, f) for g in graphs]) for f in _FIELDS[:-1]}
    fields["y"] = None if any(v is None for v in ys) else torch.stack(ys)
    return PaddedGraph(**fields)
