"""Transposed neighbor list: the slots that point at each table row.

For ``idx [B, N, K]`` over a table of ``M`` rows (``m``, default N) the list
is :class:`NeighborTranspose` ``(offsets, slots)``: ``offsets [B, M + 1]``
int32 and ``slots [B, N * K]`` int32, where the group of row ``m`` of graph
``b`` is ``slots[b, offsets[b, m] : offsets[b, m + 1]]``, the flat slots ``s
= n * K + k`` with ``idx[b, n, k] == m``, in increasing order. An index
outside ``[0, M)`` is dropped; the tail of ``slots[b]`` past ``offsets[b,
M]`` is -1. The content is fixed by ``idx`` and M alone, so the kernel's
result is bit-equal to the plain version. M differs from N for the halo
tier's rectangular gathers (``parallel/halo.py``): a rank's ``[local ||
halo]`` table, and the local rows it sends.

The two gather backwards (``gather_rows_bwd``, ``weighted_gather_sum_bwd``)
are gather-sums over this list: each destination row sums its own slots in
a fixed order, with no atomics. The CUDA kernel is
``csrc/neighbor_transpose.cu``: a stable counting sort on one thread-block
cluster per graph, whose CTAs count their segments of the slots per warp in
shared memory and scan the rows across the cluster through distributed
shared memory. It has no TPU counterpart, since the TPU backward contracts
one-hot tiles instead. :func:`launch_plan` sets its shape from (B, N, K, M)
alone: the cluster's size, the warps a CTA, each CTA's slots and rows, and
its shared memory (``4 * ((W + 1) * M + C * chunk)`` bytes, 192 KiB at M =
8192; past :data:`SMEM_LIMIT`, from M ~ 9550 rows, a global scratch buffer
instead). Each call also takes an int32 rank buffer of B * N * K words.

A model builds the list once per neighbor-index tensor in a forward that a
gradient will be taken through (:func:`transpose_for_backward`) and hands
it to every layer of that level; a gather called without one builds it in
its backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .build import CudaKernel

KERNEL = CudaKernel("neighbor_transpose", "neighbor_transpose_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # idx, offsets, slots
    ctypes.c_void_p, ctypes.c_void_p,                       # ranks, scratch
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,         # B, N * K, M
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,         # warps, cluster, seg
    ctypes.c_int64, ctypes.c_int64,                         # chunk, smem
    ctypes.c_void_p])                                       # stream

SMS = 132                       # the H100's SMs, which B clusters of C CTAs should fill
WARP_CHOICES = (8, 4)           # warps a CTA: 8 where their counters fit shared memory
MAX_CLUSTER = 16                # CTAs a graph at most (the launch allows non-portable sizes)
SMEM_LIMIT = 224 * 1024         # a CTA's counters in shared memory up to this many bytes
MAX_ROWS = 2 ** 27 - 1          # rows the kernel's sort keys (row << 5 | lane) have room for


def _cdiv(a: int, d: int) -> int:
    return -(-a // d)


def cta_ints(m: int, warps: int, cluster: int, chunk: int) -> int:
    """Int32 words of one CTA's counters: cnt [warps][m] and tot [m] (m
    padded to 4), then the cluster's shares of its chunk, [cluster][chunk]
    (``cta_ints`` in the .cu)."""
    return (warps + 1) * _cdiv(m, 4) * 4 + cluster * chunk


class LaunchPlan(NamedTuple):
    cluster: int                # CTAs a graph (C), one cluster each
    grid: int                   # B * C
    warps: int                  # a CTA's warps (W): each counts its part of the CTA's slots
    segment: int                # slots a CTA, a multiple of 32 * W; CTA r: [r * seg, (r + 1) * seg)
    chunk: int                  # rows a CTA scans across the cluster, a multiple of 4
    smem: int                   # dynamic shared memory a CTA, bytes (0: counters in scratch)
    scratch: int                # int32 words of global scratch (0: counters in shared memory)

    @property
    def threads(self) -> int:
        return 32 * self.warps


def launch_plan(b: int, n: int, k: int, m: int) -> LaunchPlan:
    """The kernel's launch for idx [b, n, k] over m rows: C from the batch
    alone, the largest power of two <= 16 with b * C <= 132 (one CTA a graph
    only once the batch fills the card); 8 warps a CTA where their counters
    fit SMEM_LIMIT, else 4; each CTA a segment of the n * k slots (whole
    32-slot tiles for each warp; a small graph leaves the last CTAs none) and
    a chunk of the m rows (a multiple of 4). Counters that do not fit with 4
    warps go to global scratch."""
    nk = n * k
    c = 1
    while 2 * c <= MAX_CLUSTER and b * 2 * c <= SMS:
        c *= 2
    chunk = _cdiv(_cdiv(m, c), 4) * 4
    fits = [w for w in WARP_CHOICES if 4 * cta_ints(m, w, c, chunk) <= SMEM_LIMIT]
    w = fits[0] if fits else WARP_CHOICES[-1]
    seg = _cdiv(_cdiv(nk, c), 32 * w) * 32 * w
    words = cta_ints(m, w, c, chunk)
    return LaunchPlan(cluster=c, grid=b * c, warps=w, segment=seg, chunk=chunk,
                      smem=4 * words if fits else 0, scratch=0 if fits else b * c * words)


# where the model builds the list for a backward: only the card runs a
# backward kernel that reads it (a CPU gather builds it in its backward)
BUILD_DEVICES = ("cuda",)


class NeighborTranspose(NamedTuple):
    offsets: torch.Tensor       # [B, M + 1] int32
    slots: torch.Tensor         # [B, N * K] int32


def _rows(idx: torch.Tensor, m: Optional[int]) -> int:
    """The table's row count M: ``m``, or N where it is None."""
    return idx.shape[1] if m is None else int(m)


def _check(idx: torch.Tensor, m: int) -> None:
    if idx.dim() != 3 or idx.dtype != torch.int32:
        raise ValueError(f"need int32 idx [B, N, K], got {tuple(idx.shape)} {idx.dtype}")
    b, n, k = idx.shape
    if n * k >= 2 ** 31 or m >= MAX_ROWS or m < 0:
        raise ValueError(f"N * K = {n * k} slots over M = {m} rows do not fit int32")


def check_transpose(nbr_t: NeighborTranspose, idx: torch.Tensor,
                    m: Optional[int] = None) -> None:
    """Raise unless ``nbr_t`` has the shapes, types and device of the list of
    idx over a table of ``m`` rows (default N)."""
    b, n, k = idx.shape
    m = _rows(idx, m)
    off, slots = nbr_t
    if (off.shape != (b, m + 1) or slots.shape != (b, n * k) or off.dtype != torch.int32
            or slots.dtype != torch.int32):
        raise ValueError(f"transposed list {tuple(off.shape)} {tuple(slots.shape)} does not "
                         f"fit idx {tuple(idx.shape)} over {m} rows")
    if off.device != idx.device or slots.device != idx.device:
        raise ValueError("the transposed list must be on idx's device")
    if not (off.is_contiguous() and slots.is_contiguous()):
        raise ValueError("the transposed list must be contiguous")


def neighbor_transpose_plain(idx: torch.Tensor, m: Optional[int] = None
                             ) -> NeighborTranspose:
    """Plain PyTorch version: a stable argsort of the destinations (out of
    range sorted last), their counts and an exclusive cumsum."""
    b, n, k = idx.shape
    m = _rows(idx, m)
    valid = (idx >= 0) & (idx < m)
    key = torch.where(valid, idx, m).reshape(b, n * k).long()
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros(b, m + 1, dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros(b, m + 1, dtype=torch.int32, device=idx.device)
    offsets[:, 1:] = counts[:, :m].cumsum(1)
    filled = torch.arange(n * k, device=idx.device) < offsets[:, m:]
    slots = torch.where(filled, order, -1).to(torch.int32)
    return NeighborTranspose(offsets, slots)


def _launch(idx: torch.Tensor, m: int) -> NeighborTranspose:
    if not idx.is_contiguous():
        raise ValueError("neighbor_transpose needs a contiguous idx")
    b, n, k = idx.shape
    offsets = torch.empty((b, m + 1), dtype=torch.int32, device=idx.device)
    slots = torch.empty((b, n * k), dtype=torch.int32, device=idx.device)
    if b == 0:
        return NeighborTranspose(offsets, slots)
    plan = launch_plan(b, n, k, m)
    ranks = torch.empty(b * n * k, dtype=torch.int32, device=idx.device)
    scratch = (torch.empty(plan.scratch, dtype=torch.int32, device=idx.device)
               if plan.scratch else None)
    with torch.cuda.device(idx.device):   # the kernel launches on the current device
        KERNEL.launch(idx.data_ptr(), offsets.data_ptr(), slots.data_ptr(), ranks.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), b, n * k, m,
                      plan.warps, plan.cluster, plan.segment, plan.chunk, plan.smem,
                      torch.cuda.current_stream().cuda_stream)
    return NeighborTranspose(offsets, slots)


def neighbor_transpose(idx: torch.Tensor, m: Optional[int] = None) -> NeighborTranspose:
    """The transposed list of idx [B, N, K] int32 over a table of ``m`` rows
    (default N): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    m = _rows(idx, m) if idx.dim() == 3 else 0
    _check(idx, m)
    if idx.device.type == "cpu":
        return neighbor_transpose_plain(idx, m)
    if idx.device.type != "cuda":
        raise ValueError(f"neighbor_transpose runs on cuda or cpu, not {idx.device}")
    return _launch(idx, m)


def transpose_for_backward(idx: torch.Tensor, m: Optional[int] = None
                           ) -> Optional[NeighborTranspose]:
    """idx's transposed list over ``m`` rows (default N) when a gradient will
    be taken (grad mode on) on a device in :data:`BUILD_DEVICES`, else None:
    inference builds nothing."""
    if not (torch.is_grad_enabled() and idx.device.type in BUILD_DEVICES):
        return None
    idx = idx.contiguous()
    return neighbor_transpose(idx, m)
