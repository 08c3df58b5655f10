"""Dense, LayerNorm and activations with the JAX package's (flax) numerics.

* ``Dense`` casts input, weight and bias to its compute dtype, as
  ``flax.linen.Dense(dtype=...)`` does; parameters stay f32.
* ``LayerNorm`` uses eps 1e-6, takes its statistics in f32 and casts the
  output to the compute dtype.
* ``gelu`` is the tanh approximation (``flax.linen.gelu``).

Parameters are created empty-valued (zeros/ones) and drawn by
:func:`init_parameters` from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def as_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


class Dense(nn.Linear):
    """``nn.Linear`` (weight [out, in]) computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        # values come from init_parameters or a converted checkpoint
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, f32 statistics, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu, "relu": F.relu, "silu": F.silu, "tanh": torch.tanh}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; options: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


# parameters drawn from N(0, 0.02), as flax's normal(0.02) initializer
NORMAL_002 = ("global_query", "mask_token")


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization with flax's defaults: Dense weights lecun-normal
    (truncated normal, variance 1/fan_in), biases zero, LayerNorm ones/zeros,
    learned queries and the mask token N(0, 0.02)."""
    for m in module.modules():
        if isinstance(m, Dense):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] in NORMAL_002:
            p.normal_(0.0, 0.02, generator=generator)
    return module
