"""Int8 (w8a8) matrix products: the JAX package's ``ops/quant.py`` formulas.

* weights: symmetric per-output-channel int8 (:func:`quantize_weight`);
* activations: symmetric per-row dynamic int8 (:func:`quantize_activations`);
* the product in int32 (:func:`int8_matmul`), dequantized by the outer
  product of the two scale vectors, the bias added in f32 (:func:`int8_dense`).

Every scale is ``where(absmax > 0, absmax / 127, 1)`` in f32 and every value
``clip(round(x / scale), -127, 127)``; ``torch.round`` rounds half to even,
as ``jnp.round`` does. The JAX package runs these formulas under ``jax.jit``,
where XLA turns the division by the constant 127 into a product with the f32
reciprocal (``absmax * 0.00787401572``); the port computes that product, so
that its int8 values equal the compiled reference's (a quotient one ulp off
moves a value that lies at a rounding tie, as the weights of a dequantized
int8 bundle often do).

On a CUDA tensor the product is ``torch._int_mm`` (cuBLASLt's int8 GEMM).
cuBLASLt wants more than 16 rows and K and N each a multiple of 8: a smaller
operand is padded with zeros, which leaves every sum as it was, and the
result is sliced. Nothing falls back to a float product. The weight is kept
as a contiguous ``[N, K]`` int8 matrix and passed transposed, the layout of
cuBLASLt's int8 tensor-core path. :func:`int8_matmul_plain` is the plain
version: the same sums in f64 (exact for any K below 2^38), on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

INT8_MAX = 127.0
# 1 / 127 rounded to f32, as XLA folds ``absmax / 127``
INV_INT8_MAX = torch.tensor(1.0 / INT8_MAX, dtype=torch.float32).item()
# cuBLASLt's int8 GEMM: rows > MIN_ROWS, K and N multiples of ALIGN
MIN_ROWS, PAD_ROWS, ALIGN = 16, 32, 8


def _symmetric(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(absmax > 0, absmax * INV_INT8_MAX, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 of a weight. ``axis`` is the output-channel
    axis, kept unreduced (-1 for a JAX ``kernel [K, N]``; 0 for a
    ``Dense.weight [N, K]``). Returns ``(w_q int8, scale f32)``, ``w ≈ w_q * scale``
    with ``scale`` shaped to broadcast against ``w``."""
    w = w.float()
    axis = axis % w.dim()
    return _symmetric(w, tuple(i for i in range(w.dim()) if i != axis))


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 over the last axis: ``(x_q int8 [..., K],
    s_x f32 [..., 1])`` with ``x ≈ x_q * s_x``."""
    return _symmetric(x.float(), (-1,))


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple - n


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q [M, K] int8`` times ``w_q [N, K] int8`` transposed -> ``[M, N]``
    int32: ``torch._int_mm``, its operands zero-padded on a CUDA tensor to the
    shapes cuBLASLt takes."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.device.type != "cuda":
        return torch._int_mm(x_q, w_q.t())
    pk, pn = _pad_to(k, ALIGN), _pad_to(n, ALIGN)
    pm = PAD_ROWS - m if m <= MIN_ROWS else 0
    if pk or pm:
        x_q = F.pad(x_q, (0, pk, 0, pm))
    if pk or pn:
        w_q = F.pad(w_q, (0, pk, 0, pn))
    out = torch._int_mm(x_q.contiguous(), w_q.contiguous().t())
    return out[:m, :n] if (pm or pn) else out


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_matmul`: f64 sums of the int8
    products, exact, as int32."""
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, matmul=int8_matmul) -> torch.Tensor:
    """A dense layer on dynamic int8 activations and int8 weights: ``x [..., K]``
    (any float dtype, quantized from f32), ``w_q [N, K] int8``, ``w_scale`` of N
    elements (from :func:`quantize_weight`), ``bias [N]``. Returns f32
    ``[..., N] ≈ x @ (w_q * w_scale).T + bias``. ``matmul``: the int32 product
    (:func:`int8_matmul_plain` to check it)."""
    lead = x.shape[:-1]
    x_q, s_x = quantize_activations(x.reshape(-1, x.shape[-1]))
    # the outer product of the scales first, as the JAX package forms it
    out = matmul(x_q, w_q).float() * (s_x * w_scale.reshape(1, -1).float())
    if bias is not None:
        out = out + bias.float()
    return out.reshape(*lead, w_q.shape[0])
