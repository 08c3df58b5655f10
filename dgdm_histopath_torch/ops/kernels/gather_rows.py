"""Neighbor row gather: ``out[b, n, k, :] = src[b, idx[b, n, k], :]``.

Replaces ``dgdm_histopath_tpu/ops/pallas/gather_rows.py::_fwd_kernel``, the
key gather of every ``DynamicGraphLayer``. The CUDA kernel is
``csrc/gather_rows.cu``: a bit-exact copy, bound on the H100 by the bytes it
writes (~23 us at B=32, N=1024, K=8, F=128 bf16). Each thread moves one
16-byte chunk of a row, so loads and stores are coalesced; the source note
in the .cu file has the details.

An index outside ``[0, N)`` gives a zero row in both versions (the TPU
one-hot kernel's result), where ``take_along_axis`` would clamp.
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


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, n, k] = src[b, idx[b, n, k]]``: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. src [B, N, F] bf16|f32,
    idx [B, N, K] int32 -> [B, N, K, F] in src's dtype."""
    _check(src, idx)
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {src.device}")
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
