"""Weighted neighbor aggregation:
``out[b, n, :] = Σ_k w[b, n, k] · h[b, idx[b, n, k], :]`` (f32 out).

Replaces ``dgdm_histopath_tpu/ops/pallas/gather_agg.py::_kernel``, the
message sum of each ``GraphConvolution``. The CUDA kernel is
``csrc/gather_agg.cu``: one warp per destination row, idx and w loaded once
per row, the K-term sum in f32 registers. It is bound on the H100 by bytes
(~8 us at B=32, N=1024, K=8, F=128 bf16 h); the source note in the .cu
file has the details.

An index outside ``[0, N)`` contributes nothing in both versions (the TPU
one-hot kernel's zero row).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel
from .gather_rows import gather_rows_plain

KERNEL = CudaKernel("gather_agg", "gather_agg_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, idx, w, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # B, N, K, F
    ctypes.c_int, ctypes.c_void_p])                                      # bf16?, stream

DTYPES = (torch.bfloat16, torch.float32)


def weighted_gather_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: h [B, N, F], idx/w [B, N, K] -> [B, N, F] f32."""
    return (gather_rows_plain(h, idx).float() * w[..., None]).sum(-2)


def _check(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> None:
    if h.dim() != 3 or idx.dim() != 3 or w.shape != idx.shape:
        raise ValueError(f"need h [B, N, F], idx and w [B, N, K], got "
                         f"{tuple(h.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    if idx.shape[:2] != h.shape[:2]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match h {tuple(h.shape)}")
    if h.dtype not in DTYPES:
        raise TypeError(f"weighted_gather_sum takes bf16 or f32 h, got {h.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"weighted_gather_sum takes int32 idx and f32 w, got "
                        f"{idx.dtype} and {w.dtype}")
    if not (h.device == idx.device == w.device):
        raise ValueError("h, idx and w must be on one device")


def weighted_gather_sum(h: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """``out[b, n] = Σ_k w[b, n, k] · h[b, idx[b, n, k]]``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. [B, N, F] f32 out."""
    _check(h, idx, w)
    if h.device.type == "cpu":
        return weighted_gather_sum_plain(h, idx, w)
    if h.device.type != "cuda":
        raise ValueError(f"weighted_gather_sum runs on cuda or cpu, not {h.device}")
    if not (h.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_gather_sum needs contiguous h, idx and w")
    b, n, f = h.shape
    k = idx.shape[-1]
    out = torch.empty((b, n, f), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(h.device):     # the kernel launches on the current device
        KERNEL.launch(h.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                      b, n, k, f, int(h.dtype == torch.bfloat16),
                      torch.cuda.current_stream().cuda_stream)
    return out
