"""Neighbor row gather: ``out[b, n, k, :] = src[b, idx[b, n, k], :]``.

Replaces ``dgdm_histopath_tpu/ops/pallas/gather_rows.py::_fwd_kernel``, the
key gather of every ``DynamicGraphLayer``. The CUDA kernel is
``csrc/gather_rows.cu``: a bit-exact copy, bound on the H100 by the bytes it
writes (~23 us at B=32, N=1024, K=8, F=128 bf16). Each thread moves one
16-byte chunk of a row, so loads and stores are coalesced; the source note
in the .cu file has the details.

The backward, ``dsrc[b, m, :] = Σ_{(n,k): idx[b,n,k]=m} g[b, n, k, :]``,
replaces ``gather_rows.py::_bwd_kernel`` and is ``csrc/gather_rows_bwd.cu``:
a gather-sum over the transposed neighbor list (``neighbor_transpose.py``),
each destination row summing its own slots in a fixed order, in f64, and
rounding once to g's dtype (the TPU kernel accumulates in f32, then casts;
f64 keeps the thousands of terms of a hub row exact), so it is
bit-reproducible. ``gather_rows`` is a ``torch.autograd.Function``:
on a CUDA tensor over the two kernels, on a CPU tensor over their plain
versions. It takes the transposed list of ``idx`` as ``nbr_t`` where the
caller has it (a model builds one per level) and builds it in its backward
where not.

An index outside ``[0, N)`` gives a zero row in both versions (the TPU
one-hot kernel's result), where ``take_along_axis`` would clamp; in the
backward it adds nothing.

The source may hold another row count than the indices: src [B, N_src, F]
and idx [B, N, K] (the halo tier's gathers, ``parallel/halo.py``). Such a
rectangular gather is forward only, as the JAX package's halo tier is: its
backward raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CudaKernel, dtype_code
from .neighbor_transpose import (
    NeighborTranspose,
    check_transpose,
    neighbor_transpose,
    neighbor_transpose_plain,
)

KERNEL = CudaKernel("gather_rows", "gather_rows_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # src, idx, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,          # B, N, K
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])        # N_src, row bytes, stream

KERNEL_BWD = CudaKernel("gather_rows_bwd", "gather_rows_bwd_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, offsets, slots, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # B, N, K, F
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])                        # dtype, vec?, stream

DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def index_in_range(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, safe): where ``idx`` lies in [0, n), and ``idx`` as int64 with
    the other entries set to 0, so that ``torch.gather`` never sees them (on
    a CUDA tensor an out-of-range gather index is a device-side assert)."""
    valid = (idx >= 0) & (idx < n)
    return valid, torch.where(valid, idx, 0).long()


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: src [B, N_src, F], idx [B, N, K] -> [B, N, K, F]."""
    b, n_src, f = src.shape
    n, k = idx.shape[1:]
    valid, safe = index_in_range(idx, n_src)
    safe = safe.reshape(b, n * k, 1).expand(b, n * k, f)
    rows = torch.gather(src, 1, safe).reshape(b, n, k, f)
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=src.dtype,
                                                           device=src.device))


def transposed_sum(nbr_t: NeighborTranspose, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Plain gather-sum over a transposed list: ``out[b, m] = Σ_{s in T(b, m)}
    rows[b, s]`` for rows [B, S, F] (S = N·K slots) -> f32 [B, n, F], summed
    in f64 as the kernels sum (a hub row's thousands of terms stay exact to
    below f32 rounding) and rounded once. Shapes depend on no data (no host
    sync), so it runs in a CUDA graph."""
    offsets, slots = nbr_t
    b, s_len, f = rows.shape
    batch = torch.arange(b, device=rows.device).view(b, 1)
    # the destination of list position p: offsets[m] <= p < offsets[m + 1];
    # positions past a graph's last group (its -1 tail) land in row n, dropped
    pos = torch.arange(s_len, device=rows.device).expand(b, s_len).contiguous()
    dest = torch.searchsorted(offsets[:, 1:].long().contiguous(), pos, right=True)
    src = slots.long().clamp_min(0) + s_len * batch
    acc = torch.zeros(b * (n + 1), f, dtype=torch.float64, device=rows.device)
    acc.index_add_(0, (dest + (n + 1) * batch).reshape(-1),
                   rows.reshape(-1, f).double()[src.reshape(-1)])
    return acc.view(b, n + 1, f)[:, :n].float()


def gather_rows_bwd_plain(idx: torch.Tensor, g: torch.Tensor,
                          nbr_t: Optional[NeighborTranspose] = None) -> torch.Tensor:
    """Plain PyTorch version of the backward, in the kernel's gather form:
    idx [B, N, K], g [B, N, K, F] -> dsrc [B, N, F] in g's dtype, each row
    summed in f64 over its slots of the transposed list (built here when
    ``nbr_t`` is None) and rounded once through f32."""
    b, n, k, f = g.shape
    nbr_t = neighbor_transpose_plain(idx) if nbr_t is None else nbr_t
    return transposed_sum(nbr_t, g.reshape(b, n * k, f), n).to(g.dtype)


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"need src [B, N_src, F] and idx [B, N, K], got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.shape[0] != src.shape[0]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match src {tuple(src.shape)}")
    if src.dtype not in DTYPES:
        raise TypeError(f"gather_rows takes bf16, f16 or f32 src, got {src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 idx, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")


def _launch_fwd(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous src and idx")
    b, n_src, f = src.shape
    n, k = idx.shape[1:]
    out = torch.empty((b, n, k, f), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):   # the kernel launches on the current device
        KERNEL.launch(src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, k, n_src,
                      f * src.element_size(), torch.cuda.current_stream().cuda_stream)
    return out


def rows_aligned(f: int, *tensors: torch.Tensor) -> bool:
    """Whether rows of F elements of each tensor start on 16 bytes, so the
    backward kernels take 16-byte loads."""
    return all((f * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0 for t in tensors)


def gather_rows_bwd(idx: torch.Tensor, g: torch.Tensor,
                    nbr_t: Optional[NeighborTranspose] = None) -> torch.Tensor:
    """``dsrc[b, m] = Σ_{(n,k): idx[b,n,k]=m} g[b, n, k]`` by the CUDA kernel,
    one launch. idx [B, N, K] int32, g [B, N, K, F] bf16|f16|f32, both contiguous
    CUDA tensors -> [B, N, F] in g's dtype (a sum past f16's range is inf, as
    the TPU kernel's f32 sum cast to f16 is). ``nbr_t`` is idx's transposed list
    (``neighbor_transpose``), built here when None. The sums run in a fixed
    order: the result is bit-identical from run to run."""
    if g.dim() != 4 or g.shape[:3] != idx.shape or g.dtype not in DTYPES:
        raise ValueError(f"need g [B, N, K, F] bf16|f16|f32 for idx {tuple(idx.shape)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device.type != "cuda" or idx.device != g.device or idx.dtype != torch.int32:
        raise ValueError("gather_rows_bwd needs g and int32 idx on one CUDA device")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_bwd needs contiguous g and idx")
    if nbr_t is None:
        nbr_t = neighbor_transpose(idx)
    check_transpose(nbr_t, idx)
    b, n, k, f = g.shape
    out = torch.empty((b, n, f), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(g.device):
        KERNEL_BWD.launch(g.data_ptr(), nbr_t.offsets.data_ptr(), nbr_t.slots.data_ptr(),
                          out.data_ptr(), b, n, k, f, dtype_code(g.dtype),
                          int(rows_aligned(f, g, out)), torch.cuda.current_stream().cuda_stream)
    return out


class _GatherRows(torch.autograd.Function):
    """The kernels on a CUDA tensor, their plain versions on a CPU tensor.
    ``offsets`` and ``slots`` are idx's transposed list, or both None."""

    @staticmethod
    def forward(ctx, src, idx, offsets, slots):
        ctx.save_for_backward(idx, offsets, slots)
        ctx.square = src.shape[1] == idx.shape[1]
        if src.device.type == "cpu":
            return gather_rows_plain(src, idx)
        return _launch_fwd(src, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.square:
            raise RuntimeError("a gather from a table of another row count (the halo tier) "
                               "is forward only")
        idx, offsets, slots = ctx.saved_tensors
        nbr_t = None if offsets is None else NeighborTranspose(offsets, slots)
        bwd = gather_rows_bwd_plain if g.device.type == "cpu" else gather_rows_bwd
        return bwd(idx, g.contiguous(), nbr_t), None, None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                nbr_t: Optional[NeighborTranspose] = None) -> torch.Tensor:
    """``out[b, n, k] = src[b, idx[b, n, k]]``: the CUDA kernels (forward and
    backward) for a CUDA tensor, the plain versions for a CPU tensor.
    src [B, N_src, F] bf16|f16|f32, idx [B, N, K] int32 -> [B, N, K, F] in src's
    dtype (forward only where N_src != N).
    ``nbr_t``: idx's transposed list for the backward, where the caller has it."""
    _check(src, idx)
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows runs on cuda or cpu, not {src.device}")
    offsets, slots = (None, None) if nbr_t is None else nbr_t
    if nbr_t is not None:
        check_transpose(nbr_t, idx)
    return _GatherRows.apply(src, idx, offsets, slots)
