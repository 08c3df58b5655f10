"""Neighbor row gather: ``out[b, n, k, :] = src[b, idx[b, n, k], :]``.

Replaces ``dgdm_histopath_tpu/ops/pallas/gather_rows.py::_fwd_kernel``, the
key gather of every ``DynamicGraphLayer``. The CUDA kernel is
``csrc/gather_rows.cu``: a bit-exact copy, bound on the H100 by the bytes it
writes (~23 us at B=32, N=1024, K=8, F=128 bf16). Each thread moves one
16-byte chunk of a row, so loads and stores are coalesced; the source note
in the .cu file has the details.

The backward, ``dsrc[b, m, :] = Σ_{(n,k): idx[b,n,k]=m} g[b, n, k, :]``,
replaces ``gather_rows.py::_bwd_kernel`` and is ``csrc/gather_rows_bwd.cu``:
a scatter with f32 atomic adds into an f32 accumulator, rounded once to g's
dtype (the TPU kernel's f32 accumulate, then cast). On a CUDA tensor
``gather_rows`` is a ``torch.autograd.Function`` over the two kernels; on a
CPU tensor it is the plain version under plain autograd.

An index outside ``[0, N)`` gives a zero row in both versions (the TPU
one-hot kernel's result), where ``take_along_axis`` would clamp; in the
backward it adds nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import CudaKernel

KERNEL = CudaKernel("gather_rows", "gather_rows_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # src, idx, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,          # B, N, K
    ctypes.c_int64, ctypes.c_void_p])                        # row bytes, stream

KERNEL_BWD = CudaKernel("gather_rows_bwd", "gather_rows_bwd_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, idx, acc, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # B, N, K, F
    ctypes.c_int, ctypes.c_void_p])                                      # bf16?, stream

DTYPES = (torch.bfloat16, torch.float32)


def index_in_range(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, safe): where ``idx`` lies in [0, n), and ``idx`` as int64 with
    the other entries set to 0, so that ``torch.gather`` never sees them (on
    a CUDA tensor an out-of-range gather index is a device-side assert)."""
    valid = (idx >= 0) & (idx < n)
    return valid, torch.where(valid, idx, 0).long()


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: src [B, N, F], idx [B, N, K] -> [B, N, K, F]."""
    b, n, f = src.shape
    k = idx.shape[-1]
    valid, safe = index_in_range(idx, n)
    safe = safe.reshape(b, n * k, 1).expand(b, n * k, f)
    rows = torch.gather(src, 1, safe).reshape(b, n, k, f)
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=src.dtype,
                                                           device=src.device))


def scatter_add_rows(idx: torch.Tensor, contrib: torch.Tensor, n: int) -> torch.Tensor:
    """f32 ``[B, n, F]`` sum of the rows ``contrib [B, N, K, F]`` at ``idx``
    (``index_add_``); an index outside [0, n) adds nothing."""
    b, f = contrib.shape[0], contrib.shape[-1]
    valid, safe = index_in_range(idx, n)
    flat = (safe + n * torch.arange(b, device=idx.device).view(b, 1, 1)).reshape(-1)
    rows = (contrib.float() * valid[..., None]).reshape(-1, f)
    acc = torch.zeros(b * n, f, dtype=torch.float32, device=contrib.device)
    return acc.index_add_(0, flat, rows).view(b, n, f)


def gather_rows_bwd_plain(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: idx [B, N, K], g [B, N, K, F]
    -> dsrc [B, N, F] in g's dtype, summed in f32."""
    return scatter_add_rows(idx, g, g.shape[1]).to(g.dtype)


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"need src [B, N, F] and idx [B, N, K], got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.shape[:2] != src.shape[:2]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match src {tuple(src.shape)}")
    if src.dtype not in DTYPES:
        raise TypeError(f"gather_rows takes bf16 or f32 src, got {src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 idx, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")


def _launch_fwd(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous src and idx")
    b, n, f = src.shape
    k = idx.shape[-1]
    out = torch.empty((b, n, k, f), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):   # the kernel launches on the current device
        KERNEL.launch(src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, k,
                      f * src.element_size(), torch.cuda.current_stream().cuda_stream)
    return out


def gather_rows_bwd(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dsrc[b, m] = Σ_{(n,k): idx[b,n,k]=m} g[b, n, k]`` by the CUDA kernel.
    idx [B, N, K] int32, g [B, N, K, F] bf16|f32, both contiguous CUDA
    tensors -> [B, N, F] in g's dtype. The sums are f32 atomic adds in no
    fixed order, so the result is not bit-reproducible from run to run."""
    if g.dim() != 4 or g.shape[:3] != idx.shape or g.dtype not in DTYPES:
        raise ValueError(f"need g [B, N, K, F] bf16|f32 for idx {tuple(idx.shape)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device.type != "cuda" or idx.device != g.device or idx.dtype != torch.int32:
        raise ValueError("gather_rows_bwd needs g and int32 idx on one CUDA device")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_bwd needs contiguous g and idx")
    b, n, k, f = g.shape
    acc = torch.empty((b, n, f), dtype=torch.float32, device=g.device)
    bf16 = g.dtype == torch.bfloat16
    out = torch.empty_like(acc, dtype=torch.bfloat16) if bf16 else acc
    if acc.numel() == 0:
        return out
    with torch.cuda.device(g.device):
        KERNEL_BWD.launch(g.data_ptr(), idx.data_ptr(), acc.data_ptr(), out.data_ptr(),
                          b, n, k, f, int(bf16), torch.cuda.current_stream().cuda_stream)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward and backward kernels on the card."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        return _launch_fwd(src, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd(idx, g.contiguous()), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, n, k] = src[b, idx[b, n, k]]``: the CUDA kernels (forward and
    backward) for a CUDA tensor, the plain version for a CPU tensor.
    src [B, N, F] bf16|f32, idx [B, N, K] int32 -> [B, N, K, F] in src's dtype."""
    _check(src, idx)
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {src.device}")
    return _GatherRows.apply(src, idx)
