"""k-nearest-neighbour graph construction on the device.

Counterpart of the JAX package's ``ops/knn.py``: spatial kNN on patch
coordinates (weight ``exp(-10 * dist)``) and morphological kNN on patch
features (cosine similarity), combined into one neighbour list.

Two things are held to the reference exactly:

* **Selection order.** ``lax.top_k`` puts the lower index first among equal
  keys, and on a patch lattice exact distance ties are the rule.
  ``torch.topk`` promises no order, so selection here is a stable sort on
  the key followed by the first k.
* **Rounding.** Distances are ``|a|^2 - 2ab + |b|^2`` in f32 with every
  product rounded before it is added, as the reference's code reads and as
  XLA computes it without contraction (the test suite's CPU settings,
  backend optimization level 0; at the default level XLA contracts these
  products into fused multiply-adds, which moves the reference's own
  rounding and its tie order on a lattice). Cosine similarities over up to
  ``CHAIN_MAX_DEPTH`` dimensions are the chain of fused multiply-adds that
  XLA's CPU dot runs at any level, its fused step computed in f64 (exact
  for f32 factors) and rounded once. Each operation is its own elementwise
  kernel, so the keys are the same bits on the CPU and on the card, and
  TF32 never touches them, whatever ``torch.backends`` says. Over more
  dimensions (a neural extractor's features) no elementwise formula
  reproduces XLA's blocked sums: the similarities there are f64 products,
  so the CPU and the card still select the same neighbours, and the values
  returned are their f32 rounding. Square roots are taken in f64 and
  rounded once (correctly rounded; torch's vectorized f32 ``sqrt`` on the
  CPU is one ulp off in places).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

F32_MAX = torch.finfo(torch.float32).max
# depth up to which the chained-FMA products reproduce XLA's CPU dot
CHAIN_MAX_DEPTH = 8


def _chain_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, D] @ b[M, D].T`` in f32 as a chain of fused multiply-adds
    over D in order: ``fma(a_d, b_d, acc)`` rounded once per step."""
    a64, b64 = a.double(), b.double()
    acc = a[:, None, 0] * b[None, :, 0]
    for d in range(1, a.shape[1]):
        acc = (a64[:, None, d] * b64[None, :, d] + acc.double()).float()
    return acc


def _plain_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, D] @ b[M, D].T`` in f32, each product rounded, summed in order
    over D."""
    acc = a[:, None, 0] * b[None, :, 0]
    for d in range(1, a.shape[1]):
        acc = acc + a[:, None, d] * b[None, :, d]
    return acc


def _sum_squares(a: torch.Tensor) -> torch.Tensor:
    """Row sums of squares [N] in f32, each square rounded, summed in order."""
    acc = a[:, 0] * a[:, 0]
    for d in range(1, a.shape[1]):
        acc = acc + a[:, d] * a[:, d]
    return acc


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, M] via ``|a|^2 - 2ab + |b|^2`` in f32,
    rounded as the reference rounds them."""
    a32, b32 = a.float(), b.float()
    aa = _sum_squares(a32)[:, None]
    bb = _sum_squares(b32)[None, :]
    return torch.clamp_min(aa - 2.0 * _plain_dot(a32, b32) + bb, 0.0)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root."""
    return torch.sqrt(x.double()).float()


def _band_mask(n: int, window: int, device) -> torch.Tensor:
    """[N, N] True where candidate j lies in query i's ±1 Morton block band
    (nodes pre-sorted in Morton order: row index == curve rank)."""
    blk = torch.arange(n, device=device) // window
    return (blk[:, None] - blk[None, :]).abs() <= 1


def _select(keys: torch.Tensor, k: int, descending: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of each row by key, lower index first among equal keys
    (``lax.top_k``'s order): (values, indices)."""
    values, idx = torch.sort(keys, dim=-1, descending=descending, stable=True)
    return values[:, :k], idx[:, :k]


def knn_euclidean(points: torch.Tensor, mask: torch.Tensor, k: int,
                  exclude_self: bool = True, band_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN by euclidean distance over padded rows.

    points [N, D], mask [N] bool -> (nbr_idx [N, k] int32, nbr_dist [N, k]
    f32, nbr_mask [N, k] bool). Invalid slots (padding, self, too few real
    nodes) are masked out with index 0 and distance 0.
    """
    n = points.shape[0]
    d2 = _pairwise_sq_dists(points, points)
    big = torch.tensor(F32_MAX, dtype=torch.float32, device=points.device)
    d2 = torch.where(mask[None, :], d2, big)
    if band_window is not None:
        d2 = torch.where(_band_mask(n, band_window, points.device), d2, big)
    if exclude_self:
        d2 = torch.where(torch.eye(n, dtype=torch.bool, device=points.device), big, d2)
    top, idx = _select(d2, k, descending=False)
    valid = (top < F32_MAX * 0.5) & mask[:, None]
    dist = torch.where(valid, _sqrt(torch.clamp_min(top, 0.0)), 0.0)
    return torch.where(valid, idx, 0).int(), dist, valid


def knn_cosine(features: torch.Tensor, mask: torch.Tensor, k: int,
               exclude_self: bool = True, band_window: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN by cosine similarity (morphological edges).

    Returns (nbr_idx [N, k] int32, nbr_sim [N, k] f32 in [-1, 1], nbr_mask).
    """
    n, depth = features.shape
    if depth <= CHAIN_MAX_DEPTH:
        f = features.float()
        unit = f / _sqrt(torch.clamp_min(_sum_squares(f), 1e-12))[:, None]
        sim = _chain_dot(unit, unit)
    else:
        f = features.double()
        unit = f / torch.sqrt(torch.clamp_min((f * f).sum(-1, keepdim=True), 1e-12))
        sim = unit @ unit.T
    neg = torch.tensor(-2.0, dtype=sim.dtype, device=features.device)
    sim = torch.where(mask[None, :], sim, neg)
    if band_window is not None:
        sim = torch.where(_band_mask(n, band_window, features.device), sim, neg)
    if exclude_self:
        sim = torch.where(torch.eye(n, dtype=torch.bool, device=features.device), neg, sim)
    top, idx = _select(sim, k, descending=True)
    valid = (top > -1.5) & mask[:, None]
    top = torch.where(valid, top, 0.0).float()
    return torch.where(valid, idx, 0).int(), top, valid


def spatial_edge_weights(dist: torch.Tensor, decay: float = 10.0,
                         threshold: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exp(-decay * dist)`` weights, those at or below ``threshold`` dropped:
    (weights, keep)."""
    w = torch.exp(-decay * dist)
    keep = w > threshold
    return w * keep.to(w.dtype), keep


def build_dual_knn(pos: torch.Tensor, features: torch.Tensor, mask: torch.Tensor,
                   k_spatial: int = 8, k_morph: int = 16, decay: float = 10.0,
                   band_window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The combined spatial + morphological neighbour lists, width
    ``k_spatial + k_morph``. ``edge_attr`` [N, K, 3] is (distance, spatial
    weight, cosine similarity), zero where a slot belongs to the other
    family; duplicate (i, j) pairs across the families are kept, as in the
    reference."""
    s_idx, s_dist, s_mask = knn_euclidean(pos, mask, k_spatial, band_window=band_window)
    s_w, s_keep = spatial_edge_weights(s_dist, decay=decay)
    m_idx, m_sim, m_mask = knn_cosine(features, mask, k_morph, band_window=band_window)
    zeros_s, zeros_m = torch.zeros_like(s_dist), torch.zeros_like(m_sim)
    edge_attr = torch.cat([torch.stack([s_dist, s_w, zeros_s], -1),
                           torch.stack([zeros_m, zeros_m, m_sim], -1)], dim=1)
    return {
        "nbr_idx": torch.cat([s_idx, m_idx], dim=1),
        "nbr_mask": torch.cat([s_mask & s_keep, m_mask], dim=1),
        "edge_attr": edge_attr,
        "edge_type": torch.cat([torch.zeros_like(s_idx), torch.ones_like(m_idx)], dim=1),
    }
