"""Flash spatial attention: masked softmax attention with the distance bias
``-|p_i - p_j| / tau`` that forms no ``[N, N]`` array in device memory.

Replaces ``dgdm_histopath_tpu/ops/pallas/flash_spatial.py``: the packed-heads
kernel ``_flash_kernel_packed`` (H·D = 128: every DGDM preset) and the
head-major kernel ``_flash_kernel`` (any other width). Both CUDA kernels are
in ``csrc/flash_spatial.cu``; its source note has the design and the bound.
The dtype picks the kernel: bf16 and f16 run on the tensor cores, f32 on FMAs.

:func:`flash_spatial_attention` routes as the JAX wrapper does: N must be a
multiple of the 128-row blocks and at least 128, else the dense reference
runs (that is the reference's documented behaviour for such shapes, for CPU
and CUDA tensors alike, so that both packages take one formulation for one
input); H·D = 128 goes to the packed kernel, the rest to the head-major one.
For an eligible shape a CUDA tensor launches the kernel or raises; a CPU
tensor runs the kernel's plain PyTorch version (a blockwise online softmax
with the kernel's constants and its fully-masked guard). No kernel runs on
the dense route and no launch counter moves: :func:`dense_route_calls` counts
those calls, so a caller can see that a shape went that way.

The backward has no kernel, as in the JAX package: it differentiates a
recompute through :func:`dense_reference`. ``pos`` gets a zero gradient, the
mask none.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import CudaKernel, dtype_code

NEG_INF = -1e30
BLOCK = 128
MAX_HEAD_DIM = 256
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_dense_route_calls = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,               # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,               # pos, mask, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B, N, H, D
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]   # scale, 1/tau, dtype, stream

KERNEL_PACKED = CudaKernel("flash_spatial", "flash_spatial_packed_launch", _ARGTYPES)
KERNEL_HEADMAJOR = CudaKernel("flash_spatial", "flash_spatial_headmajor_launch", _ARGTYPES)


def distance_bias(qpos: torch.Tensor, kpos: torch.Tensor, tau: float) -> torch.Tensor:
    """[..., Nq, 2], [..., Nk, 2] -> [..., Nq, Nk]: per-component differences,
    never |a|^2 + |b|^2 - 2ab (which cancels for nearby points)."""
    dx = qpos[..., :, None, 0] - kpos[..., None, :, 0]
    dy = qpos[..., :, None, 1] - kpos[..., None, :, 1]
    return -torch.sqrt(torch.clamp_min(dx * dx + dy * dy, 1e-12)) / tau


def dense_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                    node_mask: torch.Tensor, tau: float) -> torch.Tensor:
    """The dense formulation on [B, N, H, D]: the route of shapes that do not
    tile, and the recompute that the backward differentiates. Forms the
    [B, H, N, N] scores. A graph without a valid key gives the mean of v
    (softmax over equal scores), which no valid query row ever reads."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    scores = scores + distance_bias(pos.float(), pos.float(), tau)[:, None]
    scores = scores.masked_fill(~node_mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", w, v.float()).to(q.dtype)


def _online_softmax(q, k, v, bias_of_block, node_mask, block_k: int) -> torch.Tensor:
    """Blockwise online softmax over the keys; q, k, v are f32 [X, N, Hx, D]
    and ``bias_of_block(j0, j1)`` gives a bias that broadcasts against the
    [X, Hx, N, j1 - j0] scores. m, l and acc follow the kernels step by step."""
    x, n, hx, d = q.shape
    m = q.new_full((x, hx, n, 1), NEG_INF)
    l = q.new_zeros((x, hx, n, 1))
    acc = q.new_zeros((x, hx, n, d))
    for j0 in range(0, n, block_k):
        j1 = min(j0 + block_k, n)
        valid = node_mask[:, None, None, j0:j1]
        scores = torch.einsum("xnhd,xmhd->xhnm", q, k[:, j0:j1]) + bias_of_block(j0, j1)
        scores = torch.where(valid, scores, scores.new_full((), NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        # exp(-1e30 - (-1e30)) is 1 on a masked key: the validity zeroes it
        p = torch.exp(scores - m_new) * valid.to(scores.dtype)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("xhnm,xmhd->xhnd", p, v[:, j0:j1])
        m = m_new
    return (acc / l.clamp_min(1e-20)).permute(0, 2, 1, 3)


def flash_spatial_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               pos: torch.Tensor, node_mask: torch.Tensor, tau: float = 0.1,
                               block_k: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel: all heads side by side, one
    bias per (graph, key block) shared by the heads. [B, N, H, D] in and out."""
    posf = pos.float()
    scale = 1.0 / math.sqrt(q.shape[-1])

    def bias(j0, j1):
        return distance_bias(posf, posf[:, j0:j1], tau)[:, None]

    out = _online_softmax(q.float() * scale, k.float(), v.float(), bias, node_mask, block_k)
    return out.to(q.dtype)


def flash_spatial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, node_mask: torch.Tensor, tau: float = 0.1,
                        block_k: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of the head-major kernel: every (graph, head) is
    a row of its own with its own bias. [B, N, H, D] in and out."""
    b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)

    def flat(t):
        return t.float().permute(0, 2, 1, 3).reshape(b * h, n, 1, d)

    posf = pos.float().repeat_interleave(h, dim=0)
    maskf = node_mask.repeat_interleave(h, dim=0)

    def bias(j0, j1):
        return distance_bias(posf, posf[:, j0:j1], tau)[:, None]

    out = _online_softmax(flat(q) * scale, flat(k), flat(v), bias, maskf, block_k)
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3).to(q.dtype)


def _check(q, k, v, pos, node_mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k, v [B, N, H, D] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n = q.shape[:2]
    if pos.shape != (b, n, 2) or node_mask.shape != (b, n):
        raise ValueError(f"need pos [B, N, 2] and node_mask [B, N], got {tuple(pos.shape)} "
                         f"and {tuple(node_mask.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_spatial_attention takes bf16, f16 or f32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if node_mask.dtype != torch.bool:
        raise TypeError(f"node_mask must be bool, got {node_mask.dtype}")
    if not (q.device == k.device == v.device == pos.device == node_mask.device):
        raise ValueError("q, k, v, pos and node_mask must be on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads and
    cp.async copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, pos, node_mask, tau: float, packed: bool) -> torch.Tensor:
    b, n, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim <= {MAX_HEAD_DIM}, got {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    pos, node_mask = _aligned(pos.float()), _aligned(node_mask)
    out = torch.empty_like(q)
    kernel = KERNEL_PACKED if packed else KERNEL_HEADMAJOR
    with torch.cuda.device(q.device):     # the kernel launches on the current device
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                      node_mask.data_ptr(), out.data_ptr(), b, n, h, d,
                      1.0 / math.sqrt(d), 1.0 / tau, dtype_code(q.dtype),
                      torch.cuda.current_stream().cuda_stream)
    return out


class _FlashSpatial(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or its plain version (CPU tensors).
    Backward: autograd through a dense recompute."""

    @staticmethod
    def forward(ctx, q, k, v, pos, node_mask, tau, packed):
        ctx.save_for_backward(q, k, v, pos, node_mask)
        ctx.tau = tau
        if q.device.type == "cuda":
            return _launch(q, k, v, pos, node_mask, tau, packed)
        plain = flash_spatial_packed_plain if packed else flash_spatial_plain
        return plain(q, k, v, pos, node_mask, tau)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, pos, node_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = dense_reference(*leaves, pos, node_mask, ctx.tau)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        dpos = torch.zeros_like(pos) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dpos, None, None, None


def flash_route(n: int, h: int, d: int) -> str:
    """Which formulation a [*, n, h, d] input takes: ``"packed"``,
    ``"headmajor"`` or ``"dense"`` (n below, or no multiple of, the
    reference's 128-row blocks)."""
    if n % BLOCK != 0 or n < BLOCK:
        return "dense"
    return "packed" if h * d == 128 else "headmajor"


def dense_route_calls() -> int:
    """How many calls of :func:`flash_spatial_attention` took the dense route
    (no kernel launched) since the module was imported."""
    return _dense_route_calls


def flash_spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos: torch.Tensor, node_mask: torch.Tensor,
                            tau: float = 0.1) -> torch.Tensor:
    """Distance-biased masked attention without the [N, N] matrices.

    q, k, v [B, N, H, D] (bf16, f16 or f32), pos [B, N, 2], node_mask [B, N] bool
    -> [B, N, H, D] in q's dtype. :func:`flash_route` says which shapes reach
    a kernel; the CUDA kernels pick their own tiles.
    """
    global _dense_route_calls
    _check(q, k, v, pos, node_mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_spatial_attention runs on cuda or cpu, not {q.device}")
    _, n, h, d = q.shape
    route = flash_route(n, h, d)
    if route == "dense":
        _dense_route_calls += 1
        return dense_reference(q, k, v, pos, node_mask, tau)
    return _FlashSpatial.apply(q, k, v, pos, node_mask, float(tau), route == "packed")
