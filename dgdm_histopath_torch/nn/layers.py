"""Dense, LayerNorm and activations with the JAX package's (flax) numerics.

* ``Dense`` casts input, weight and bias to its compute dtype, as
  ``flax.linen.Dense(dtype=...)`` does; its parameters are stored in
  ``param_dtype`` (flax's ``param_dtype``; f32 by default).
  ``DenseGeneral`` is the same layer where the JAX package has a flax
  ``nn.DenseGeneral`` (per-head projections): int8 inference reroutes only
  ``Dense`` calls, as the JAX interceptor reroutes only ``nn.Dense``.
* ``LayerNorm`` uses eps 1e-6, takes its statistics in f32 (for bf16 and
  f16 inputs alike, as flax promotes both to f32) and casts the output to
  the compute dtype; scale and bias are stored in ``param_dtype``.
* ``gelu`` is the tanh approximation (``flax.linen.gelu``).

* ``dropout`` draws its keep mask from an explicit ``torch.Generator``
  (``F.dropout`` takes none), so a step's draws follow from its seed.

Parameters are created empty-valued (zeros/ones) and drawn by
:func:`init_parameters` from an explicit ``torch.Generator`` (in f32, then
rounded once to each parameter's dtype).
"""

from __future__ import annotations

import math
from contextvars import ContextVar
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def as_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ``interceptor(dense, x) -> output or None``, set for the length of one
# call (``models.quantized.int8_apply``); a context variable, so that
# threads serving float and int8 callers do not share it
DENSE_INTERCEPTOR: ContextVar[Optional[Callable]] = ContextVar("dense_interceptor",
                                                               default=None)


class Dense(nn.Linear):
    """``nn.Linear`` (weight [out, in]) computing in ``dtype``, its
    parameters stored in ``param_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        # values come from init_parameters or a converted checkpoint
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        intercept = DENSE_INTERCEPTOR.get()
        if intercept is not None:
            out = intercept(self, x)
            if out is not None:
                return out
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class DenseGeneral(Dense):
    """A ``Dense`` that the JAX package builds as a flax ``nn.DenseGeneral``
    (per-head outputs or inputs): the same parameters, layout and forward."""


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, f32 statistics, output in ``dtype``,
    scale and bias stored in ``param_dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-6, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: a Bernoulli(1 - rate) keep mask drawn from
    ``generator`` on x's device, survivors scaled by ``1 / (1 - rate)``.
    Callers apply it only when training (not deterministic) and rate > 0."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


ACTIVATIONS = {"gelu": gelu, "relu": F.relu, "silu": F.silu, "tanh": torch.tanh}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; options: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


# parameters drawn from N(0, 0.02), as flax's normal(0.02) initializer
NORMAL_002 = ("global_query", "mask_token")


@torch.no_grad()
def draw_into(p: torch.Tensor, draw: Callable[[torch.Tensor], object]) -> None:
    """``draw`` fills an f32 tensor of p's shape, which is copied into p
    (rounded once to p's dtype): the draws are the same whatever the
    parameter dtype."""
    if p.dtype == torch.float32:
        draw(p)
        return
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    draw(tmp)
    p.copy_(tmp)


def lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun-normal: a truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw_into(p, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                                 generator=generator))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization with flax's defaults: Dense weights lecun-normal
    (truncated normal, variance 1/fan_in), biases zero, LayerNorm ones/zeros,
    learned queries and the mask token N(0, 0.02); a module with a
    ``draw_parameters(generator)`` method draws its own."""
    for m in module.modules():
        if isinstance(m, Dense):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif hasattr(m, "draw_parameters"):      # parameters of its own (MoE, LSTM)
            m.draw_parameters(generator)
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] in NORMAL_002:
            draw_into(p, lambda t: t.normal_(0.0, 0.02, generator=generator))
    return module
