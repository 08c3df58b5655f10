"""Global graph pooling, masked and batched: [..., N, F] -> [..., F]
(counterpart of the JAX package's ``models/pooling.py``): mean, max, a
learned global query's attention, and Set2Set."""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..nn.layers import Dense, DenseGeneral, draw_into, lecun_normal_
from ..ops.graph import masked_global_max, masked_global_mean, masked_softmax


class GlobalMeanPool(nn.Module):
    def forward(self, x, node_mask):
        return masked_global_mean(x, node_mask)


class GlobalMaxPool(nn.Module):
    def forward(self, x, node_mask):
        return masked_global_max(x, node_mask)


class GlobalAttentionPool(nn.Module):
    """A learned global query [H, D] attends over the nodes; with
    ``return_weights`` also the head-averaged node attention [..., N]."""

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.global_query = nn.Parameter(torch.zeros(num_heads, embed_dim // num_heads,
                                                     dtype=param_dtype))
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.k_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.v_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.out_proj = Dense(embed_dim, embed_dim, **dt)

    def logits_values(self, x):
        """Per node: (the query's logits [..., N, H] f32, values [..., N, H, D])."""
        heads = (self.num_heads, self.embed_dim // self.num_heads)
        k = self.k_proj(x).unflatten(-1, heads)                  # [..., N, H, D]
        v = self.v_proj(x).unflatten(-1, heads)
        logits = torch.einsum("hd,...nhd->...nh", self.global_query.to(k.dtype), k)
        return logits.float() * (1.0 / math.sqrt(heads[1])), v

    def forward(self, x, node_mask, return_weights: bool = False):
        logits, v = self.logits_values(x)
        weights = masked_softmax(logits, node_mask[..., None], dim=-2)   # over N
        pooled = torch.einsum("...nh,...nhd->...hd", weights.to(v.dtype), v)
        out = self.out_proj(pooled.flatten(-2))
        if return_weights:
            return out, weights.mean(-1)
        return out


class LSTMGate(nn.Module):
    """One gate's half of flax's ``OptimizedLSTMCell``: ``weight`` [out, in]
    (flax's kernel [in, out]) and, on the recurrent side, ``bias``. Not a
    ``Dense``: flax holds these as ``DenseParams``, which neither its Dense
    initializer nor the int8 interceptor touches."""

    def __init__(self, in_features: int, features: int, bias: bool,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype)) if bias else None


class OptimizedLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` (``dtype=None``): children ``ii``,
    ``if``, ``ig``, ``io`` (input kernels, no bias) and ``hi``, ``hf``,
    ``hg``, ``ho`` (recurrent kernels and biases), gate order i, f, g, o:
    ``i, f, o = sigmoid(.)``, ``g = tanh(.)``, ``c' = f c + i g``,
    ``h' = o tanh(c')``. Each side's product runs in the promoted type of
    its input and its parameters, as flax's ``promote_dtype`` does; the
    carry starts at zeros in ``param_dtype``. Initializers: lecun-normal
    input kernels, orthogonal recurrent kernels, zero biases."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.features, self.param_dtype = in_features, features, param_dtype
        for c in self.GATES:
            self.add_module(f"i{c}", LSTMGate(in_features, features, False, param_dtype))
            self.add_module(f"h{c}", LSTMGate(features, features, True, param_dtype))

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        for c in self.GATES:
            lecun_normal_(getattr(self, f"i{c}").weight, self.in_features, generator)
            rec = getattr(self, f"h{c}")
            draw_into(rec.weight, lambda t: nn.init.orthogonal_(t, generator=generator))
            rec.bias.zero_()

    def initial_carry(self, batch_shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (*batch_shape, self.features)
        zeros = torch.zeros(shape, dtype=self.param_dtype, device=device)
        return zeros, zeros.clone()

    def _dense(self, x: torch.Tensor, side: str) -> torch.Tensor:
        gates = [getattr(self, f"{side}{c}") for c in self.GATES]
        kernel = torch.cat([g.weight for g in gates], dim=0)        # [4F, in]
        dt = torch.promote_types(x.dtype, kernel.dtype)
        y = x.to(dt) @ kernel.to(dt).T
        if side == "h":
            y = y + torch.cat([g.bias for g in gates]).to(dt)
        return y

    def forward(self, carry, x):
        c, h = carry
        y = (self._dense(h, "h") + self._dense(x, "i")).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(y[0]), torch.sigmoid(y[1]), torch.sigmoid(y[3])
        new_c = f * c + i * torch.tanh(y[2])
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GlobalSet2SetPool(nn.Module):
    """Set2Set readout (Vinyals et al.): ``num_steps`` rounds of an LSTM
    query attending over the nodes, from a zero carry and a zero ``q_star``;
    the query and the scores and readout run in f32 (``masked_softmax`` over
    the real nodes), ``q_star = [q, r]`` is kept in the input's dtype and
    ``out_proj`` maps the last one to ``embed_dim`` in ``dtype``."""

    def __init__(self, embed_dim: int, num_steps: int = 3,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_steps = embed_dim, num_steps
        self.lstm = OptimizedLSTMCell(2 * embed_dim, embed_dim, param_dtype)
        self.out_proj = Dense(2 * embed_dim, embed_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x, node_mask):
        batch_shape = x.shape[:-2]
        carry = self.lstm.initial_carry(batch_shape, x.device)
        q_star = torch.zeros((*batch_shape, 2 * self.embed_dim), dtype=x.dtype,
                             device=x.device)
        x32 = x.float()
        for _ in range(self.num_steps):
            carry, q = self.lstm(carry, q_star.float())
            logits = torch.einsum("...f,...nf->...n", q, x32)
            alpha = masked_softmax(logits, node_mask, dim=-1)
            r = torch.einsum("...n,...nf->...f", alpha, x32)
            q_star = torch.cat([q, r], dim=-1).to(x.dtype)
        return self.out_proj(q_star)


def make_pool(kind: str, embed_dim: int, num_heads: int = 8,
              dtype: torch.dtype = torch.float32,
              param_dtype: torch.dtype = torch.float32) -> nn.Module:
    if kind == "mean":
        return GlobalMeanPool()
    if kind == "max":
        return GlobalMaxPool()
    if kind == "attention":
        return GlobalAttentionPool(embed_dim, num_heads, dtype=dtype, param_dtype=param_dtype)
    if kind == "set2set":
        return GlobalSet2SetPool(embed_dim, dtype=dtype, param_dtype=param_dtype)
    raise ValueError(f"unknown pooling {kind!r}")
