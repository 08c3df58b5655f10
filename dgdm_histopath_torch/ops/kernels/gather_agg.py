"""Weighted neighbor aggregation:
``out[b, n, :] = Σ_k w[b, n, k] · h[b, idx[b, n, k], :]`` (f32 out).

Replaces ``dgdm_histopath_tpu/ops/pallas/gather_agg.py::_kernel``, the
message sum of each ``GraphConvolution``. The CUDA kernel is
``csrc/gather_agg.cu``: a group of lanes per destination row (a half-warp
at F=128 bf16), its indices and weights loaded once, the h loads of eight
slots issued before the first FMA (16 bytes a lane where rows are 16-byte
aligned), the K-term sum in f32 registers in k order; K=8 is compiled apart.
Its bound on the H100 is bytes (~8 us at B=32, N=1024, K=8, F=128 bf16 h);
the K-fold re-reads of h from L2 keep it at ~1.5x that (the source note in
the .cu file has the details).

The backward has no TPU kernel (the JAX package's is XLA, ``_vjp_bwd`` in the
same file: a scatter-add for ``dh``, a gathered dot for ``dw``); here it is
``csrc/gather_agg_bwd.cu``, one launch for both halves that forms no
``[B, N, K, F]`` tensor: ``dw`` per source row, ``dh`` as a gather-sum over
the transposed neighbor list (``neighbor_transpose.py``) in a fixed order,
so both are bit-reproducible. ``weighted_gather_sum`` is a
``torch.autograd.Function``: on CUDA tensors over the two kernels, on CPU
tensors over their plain versions. It takes idx's transposed list as
``nbr_t`` where the caller has it and builds it in its backward where not.

An index outside ``[0, M)`` contributes nothing in both versions (the TPU
one-hot kernel's zero row): ``dw`` is 0 there and ``dh`` gets nothing.

h may hold another row count than the indices: h [B, M, F], idx and w
[B, N, K] (``parallel/halo.py::sp_graph_conv`` and the layers over a node
block sum over a rank's ``[local || halo]`` table). The backward then gives
``dh [B, M, F]`` over the transposed list with M rows beside ``dw [B, N,
K]``, what JAX's ``_vjp_bwd`` computes for a table of M rows.

The forward is also the custom op ``dgdm::weighted_gather_sum`` (the kernel
on CUDA tensors, the plain version on CPU tensors, the f32 output's shape on
fake ones). The wrapper takes it only while ``torch.export`` traces, so that
an exported program carries the kernel as one node; eager calls launch
directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CudaKernel, dtype_code
from .gather_rows import gather_rows_plain, rows_aligned, transposed_sum
from .neighbor_transpose import (
    NeighborTranspose,
    check_transpose,
    neighbor_transpose,
    neighbor_transpose_plain,
)

KERNEL = CudaKernel("gather_agg", "gather_agg_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, idx, w, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,                      # B, N, K
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])      # N_src, F, dtype, stream

KERNEL_BWD = CudaKernel("gather_agg_bwd", "gather_agg_bwd_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, h, idx, w
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, slots, dh, dw
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # B, N, K, F
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])        # M, dtype, vec?, stream

DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def weighted_gather_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: h [B, M, F], idx/w [B, N, K] -> [B, N, F] f32."""
    return (gather_rows_plain(h, idx).float() * w[..., None]).sum(-2)


def weighted_gather_sum_bwd_plain(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                                  w: torch.Tensor, nbr_t: Optional[NeighborTranspose] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, in the kernel's form: g [B, N, F]
    -> (dh [B, M, F] in h's dtype, each row a gather-sum of the f32 products
    w·g over its slots of the transposed list over h's M rows, built here
    when ``nbr_t`` is None, summed in f64; dw [B, N, K] f32, a dot per slot
    in f64), each rounded once."""
    b, n, k = idx.shape
    m = h.shape[1]
    g = g.float()
    nbr_t = neighbor_transpose_plain(idx, m) if nbr_t is None else nbr_t
    contrib = (w[..., None] * g[:, :, None, :]).reshape(b, n * k, -1)
    dh = transposed_sum(nbr_t, contrib, m).to(h.dtype)
    dw = torch.einsum("bnkf,bnf->bnk", gather_rows_plain(h, idx).double(), g.double())
    return dh, dw.float()


def _check(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> None:
    if h.dim() != 3 or idx.dim() != 3 or w.shape != idx.shape:
        raise ValueError(f"need h [B, M, F], idx and w [B, N, K], got "
                         f"{tuple(h.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    if idx.shape[0] != h.shape[0]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match h {tuple(h.shape)}")
    if h.dtype not in DTYPES:
        raise TypeError(f"weighted_gather_sum takes bf16, f16 or f32 h, got {h.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"weighted_gather_sum takes int32 idx and f32 w, got "
                        f"{idx.dtype} and {w.dtype}")
    if not (h.device == idx.device == w.device):
        raise ValueError("h, idx and w must be on one device")


def _launch_fwd(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not (h.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_gather_sum needs contiguous h, idx and w")
    b, n_src, f = h.shape
    n, k = idx.shape[1:]
    if max(b * n, n_src, k, f) >= 2 ** 31:
        raise ValueError(f"weighted_gather_sum takes B * N, N_src, K and F below 2^31, got "
                         f"{b * n}, {n_src}, {k}, {f}")
    out = torch.empty((b, n, f), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(h.device):     # the kernel launches on the current device
        KERNEL.launch(h.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                      b, n, k, n_src, f, dtype_code(h.dtype),
                      torch.cuda.current_stream().cuda_stream)
    return out


@torch.library.custom_op("dgdm::weighted_gather_sum", mutates_args=(),
                         schema="(Tensor h, Tensor idx, Tensor w) -> Tensor")
def weighted_gather_sum_op(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return weighted_gather_sum_plain(h, idx, w)


@weighted_gather_sum_op.register_kernel("cuda")
def _weighted_gather_sum_op_cuda(h: torch.Tensor, idx: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    return _launch_fwd(h, idx, w)


@weighted_gather_sum_op.register_fake
def _weighted_gather_sum_op_fake(h: torch.Tensor, idx: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    return h.new_empty((*idx.shape[:2], h.shape[-1]), dtype=torch.float32)


def weighted_gather_sum_bwd(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                            w: torch.Tensor, need_dh: bool = True, need_dw: bool = True,
                            nbr_t: Optional[NeighborTranspose] = None
                            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dh [B, M, F], dw [B, N, K]) of ``weighted_gather_sum`` over the table
    h [B, M, F] for the cotangent g [B, N, F] f32, by the CUDA kernel in one
    launch; a half that is not needed is skipped and comes back as None. All
    tensors contiguous, on one CUDA device. ``nbr_t`` is idx's transposed
    list over M rows, built here when None and dh is needed. Both halves
    are summed in a fixed order: bit-identical from run to run."""
    _check(h, idx, w)
    b, m, f = h.shape
    n, k = idx.shape[1:]
    if g.shape != (b, n, f) or g.dtype != torch.float32 or g.device != h.device:
        raise ValueError(f"need f32 g {(b, n, f)} on {h.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if h.device.type != "cuda":
        raise ValueError("weighted_gather_sum_bwd runs on CUDA tensors")
    if not all(t.is_contiguous() for t in (g, h, idx, w)):
        raise ValueError("weighted_gather_sum_bwd needs contiguous g, h, idx and w")
    if max(b * n, b * m) >= 2 ** 31:
        raise ValueError(f"weighted_gather_sum_bwd takes B * N and B * M below 2^31, got "
                         f"{b * n} and {b * m}")
    dh = torch.empty_like(h) if need_dh else None
    dw = torch.empty((b, n, k), dtype=torch.float32, device=h.device) if need_dw else None
    if need_dh:
        if nbr_t is None:
            nbr_t = neighbor_transpose(idx, m)
        check_transpose(nbr_t, idx, m)
    if (need_dh and b * m > 0) or (need_dw and b * n > 0):
        def ptr(t):
            return None if t is None else t.data_ptr()
        offsets, slots = (None, None) if nbr_t is None else nbr_t
        vec = rows_aligned(f, h, *([] if dh is None else [dh])) and g.data_ptr() % 16 == 0
        with torch.cuda.device(h.device):
            KERNEL_BWD.launch(g.data_ptr(), h.data_ptr(), idx.data_ptr(), w.data_ptr(),
                              ptr(offsets), ptr(slots), ptr(dh), ptr(dw), b, n, k, f, m,
                              dtype_code(h.dtype), int(vec),
                              torch.cuda.current_stream().cuda_stream)
    return dh, dw


class _WeightedGatherSum(torch.autograd.Function):
    """The kernels on CUDA tensors, their plain versions on CPU tensors.
    ``offsets`` and ``slots`` are idx's transposed list, or both None."""

    @staticmethod
    def forward(ctx, h, idx, w, offsets, slots):
        ctx.save_for_backward(h, idx, w, offsets, slots)
        if h.device.type == "cpu":
            return weighted_gather_sum_plain(h, idx, w)
        return _launch_fwd(h, idx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, idx, w, offsets, slots = ctx.saved_tensors
        nbr_t = None if offsets is None else NeighborTranspose(offsets, slots)
        need_dh, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if g.device.type == "cpu":
            dh, dw = weighted_gather_sum_bwd_plain(g, h, idx, w, nbr_t)
            dh, dw = (dh if need_dh else None), (dw if need_dw else None)
        else:
            dh, dw = weighted_gather_sum_bwd(g.float().contiguous(), h, idx, w, need_dh,
                                             need_dw, nbr_t)
        return dh, None, dw, None, None


def weighted_gather_sum(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        nbr_t: Optional[NeighborTranspose] = None) -> torch.Tensor:
    """``out[b, n] = Σ_k w[b, n, k] · h[b, idx[b, n, k]]``: the CUDA kernels
    (forward and backward) for CUDA tensors, the plain versions for CPU
    tensors. h [B, M, F] bf16|f16|f32, idx and w [B, N, K] -> [B, N, F] f32.
    ``nbr_t``: idx's transposed list over M rows for the backward, where the
    caller has it. Under ``torch.export`` it is the op
    ``dgdm::weighted_gather_sum``, forward only."""
    _check(h, idx, w)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_gather_sum runs on cuda or cpu, not {h.device}")
    if torch.compiler.is_exporting():
        return weighted_gather_sum_op(h, idx, w)
    offsets, slots = (None, None) if nbr_t is None else nbr_t
    if nbr_t is not None:
        check_transpose(nbr_t, idx, h.shape[1])
    return _WeightedGatherSum.apply(h, idx, w, offsets, slots)
