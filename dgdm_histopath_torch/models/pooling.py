"""Global graph pooling, masked and batched: [..., N, F] -> [..., F]."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import Dense, DenseGeneral
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.global_query = nn.Parameter(torch.zeros(num_heads, embed_dim // num_heads))
        self.k_proj = DenseGeneral(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = DenseGeneral(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)

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


def make_pool(kind: str, embed_dim: int, num_heads: int = 8,
              dtype: torch.dtype = torch.float32) -> nn.Module:
    if kind == "mean":
        return GlobalMeanPool()
    if kind == "max":
        return GlobalMaxPool()
    if kind == "attention":
        return GlobalAttentionPool(embed_dim, num_heads, dtype=dtype)
    if kind == "set2set":
        raise NotImplementedError(
            "pooling='set2set' is not ported yet (ROADMAP queue 1, item 8: "
            "param_dtype, set2set and float16 still to port)")
    raise ValueError(f"unknown pooling {kind!r}")
