"""Int8 (w8a8) inference for the DGDM graph model: the JAX package's
``models/quantized.py`` on the port.

:func:`int8_apply` runs a model with every eligible :class:`~..nn.layers.Dense`
call rerouted to :func:`~..ops.quant.int8_dense`: symmetric per-output-channel
int8 weights, dynamic per-row int8 activations, int32 products, the bias in
f32. Eligible are the modules whose type is ``Dense`` itself (never a
``DenseGeneral``: the JAX interceptor reroutes ``flax.linen.Dense`` only, and
flax's ``DenseGeneral`` is no subclass of it) with input and output widths
both at least ``min_features``. So the per-head projections, the MoE router
(E < 64), narrow heads, the expert products and every data-by-data product
(aggregation, attention) keep their float numerics.

The switch is per call: :data:`~..nn.layers.DENSE_INTERCEPTOR`, a context
variable, holds the interceptor while :func:`int8_apply` runs, so float and
int8 callers share one model across threads. A module's int8 weight is
computed at its first int8 call and kept until the weight changes (its
version counter or storage). The ViT featurizer has its own int8 forward
(``models/vit_int8.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator, Optional

import torch
from torch import nn

from ..nn.layers import DENSE_INTERCEPTOR, Dense
from ..ops.quant import int8_dense, quantize_weight

__all__ = ["float_apply", "int8_apply", "int8_apply_fn", "intercept_dense",
           "make_int8_interceptor"]


def _int8_weight(mod: Dense):
    """``(w_q [N, K] int8, scale [N] f32)`` of ``mod.weight``, cached on the
    module under the weight's version, storage and device."""
    w = mod.weight
    key = (w._version, w.data_ptr(), w.device)
    cached = getattr(mod, "_int8_weight", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            w_q, scale = quantize_weight(w.detach(), axis=0)
        cached = (key, w_q.contiguous(), scale.reshape(-1))
        mod._int8_weight = cached
    return cached[1], cached[2]


def _int8_dense_call(mod: Dense, x: torch.Tensor) -> torch.Tensor:
    w_q, w_scale = _int8_weight(mod)
    return int8_dense(x, w_q, w_scale, mod.bias).to(mod.compute_dtype)


def make_int8_interceptor(min_features: int = 64) -> Callable:
    """``interceptor(dense, x)``: the int8 output of an eligible ``Dense``
    call (input width and output width both >= ``min_features``), else None
    (the float forward runs)."""

    def interceptor(mod: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
        if (type(mod) is Dense and x.shape[-1] >= min_features
                and mod.out_features >= min_features):
            return _int8_dense_call(mod, x)
        return None

    return interceptor


@contextlib.contextmanager
def intercept_dense(interceptor: Callable) -> Iterator[None]:
    """Every ``Dense`` call in this context (and thread) asks ``interceptor``
    first, as flax's ``nn.intercept_methods`` does."""
    token = DENSE_INTERCEPTOR.set(interceptor)
    try:
        yield
    finally:
        DENSE_INTERCEPTOR.reset(token)


def int8_apply(model: nn.Module, *args, min_features: int = 64, **kwargs):
    """``model(*args, **kwargs)`` with every eligible ``Dense`` on the int8
    path: ``int8_apply(model, graph, mode="inference")``. Inference only:
    rounding has no useful gradient."""
    with intercept_dense(make_int8_interceptor(min_features)):
        return model(*args, **kwargs)


def float_apply(model: nn.Module, *args, **kwargs):
    """``model(*args, **kwargs)``: the float counterpart of :func:`int8_apply`."""
    return model(*args, **kwargs)


def int8_apply_fn(model: nn.Module, min_features: int = 64) -> Callable:
    """:func:`int8_apply` bound to ``model``."""
    return functools.partial(int8_apply, model, min_features=min_features)
