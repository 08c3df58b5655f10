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
``csrc/neighbor_transpose.cu`` (a stable counting sort, one block per
graph); it has no TPU counterpart, since the TPU backward contracts one-hot
tiles instead. Per graph it keeps ``4 * counters(M)`` bytes of counters in
shared memory, and in a global scratch buffer above :data:`SMEM_LIMIT`.

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
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, offsets, slots, scratch
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # B, N, K, M
    ctypes.c_void_p])                                                    # stream

WARPS = 16                      # the kernel's warps per graph: counters per node
SMEM_LIMIT = 160 * 1024         # counters in shared memory up to this many bytes


def counters(m: int) -> int:
    """Int32 counters the kernel keeps for a table of m rows: [m][WARPS]
    with one pad word per 32 (``neighbor_transpose_counters`` in the .cu)."""
    return m * WARPS + (m * WARPS >> 5) + 1


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
    if n * k >= 2 ** 31 or m * WARPS >= 2 ** 31 or m < 0:
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
    scratch = (torch.empty(b * counters(m), dtype=torch.int32, device=idx.device)
               if counters(m) * 4 > SMEM_LIMIT else None)
    with torch.cuda.device(idx.device):   # the kernel launches on the current device
        KERNEL.launch(idx.data_ptr(), offsets.data_ptr(), slots.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), b, n, k, m,
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
