"""Masked dense attention, 2-D positional encoding and ``SpatialAttention``.

Counterpart of the JAX package's ``nn/attention.py``. Only the dense path
of ``SpatialAttention`` is ported: the model never takes the flash path
(it needs ``use_flash``, and returning weights forces dense), and the
windowed path is ROADMAP work. Softmax math and its buffers are f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Dense, LayerNorm, dropout


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked SDPA. q [..., Lq, H, D], k/v [..., Lk, H, D].

    Returns (out [..., Lq, H, D], weights [..., H, Lq, Lk]). Query rows
    with no valid key come out as zeros. ``dropout_rate > 0`` drops
    attention weights with draws from ``generator``.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[..., None, None, :],
                                    torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    if key_mask is not None:
        any_key = key_mask.any(-1)[..., None, None, None]
        weights = torch.where(any_key, weights, torch.zeros((), device=weights.device))
    weights = dropout(weights, dropout_rate, generator)
    out = torch.einsum("...hqk,...khd->...qhd", weights.to(v.dtype), v)
    return out, weights


def sinusoidal_position_encoding_2d(pos: torch.Tensor, dim: int,
                                    temperature: float = 10000.0) -> torch.Tensor:
    """pos [..., N, 2] in [0, 1] -> [..., N, dim]; half the channels encode
    x, half encode y."""
    quarter = (dim // 2) // 2
    freqs = torch.exp(-math.log(temperature)
                      * torch.arange(quarter, dtype=torch.float32, device=pos.device)
                      / max(quarter, 1))

    def enc(coord):
        args = coord[..., None] * freqs * (2.0 * math.pi)
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    out = torch.cat([enc(pos[..., 0].float()), enc(pos[..., 1].float())], dim=-1)
    pad = dim - out.shape[-1]
    if pad > 0:
        out = torch.nn.functional.pad(out, (0, pad))
    return out


class SpatialAttention(nn.Module):
    """Self-attention over nodes with 2-D positional encoding and a
    ``-distance / tau`` bias, masked and batched (dense path)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 distance_tau: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.distance_tau = distance_tau
        self.compute_dtype = dtype
        self.pos_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, node_mask: torch.Tensor,
                return_weights: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """x [B, N, D], pos [B, N, 2], node_mask [B, N] bool. When not
        deterministic, dropout falls on the attention weights."""
        pos_enc = sinusoidal_position_encoding_2d(pos, self.embed_dim).to(x.dtype)
        h = x + self.pos_proj(pos_enc)
        heads = (self.num_heads, self.embed_dim // self.num_heads)
        q = self.q_proj(h).unflatten(-1, heads)
        k = self.k_proj(h).unflatten(-1, heads)
        v = self.v_proj(h).unflatten(-1, heads)
        # per-component differences, not |a|^2 + |b|^2 - 2ab, which cancels
        # badly for nearby points
        posf = pos.float()
        dx = posf[..., :, None, 0] - posf[..., None, :, 0]
        dy = posf[..., :, None, 1] - posf[..., None, :, 1]
        dist = torch.sqrt(torch.clamp_min(dx * dx + dy * dy, 1e-12))
        bias = (-dist / self.distance_tau)[..., None, :, :]
        ctx, weights = scaled_dot_product_attention(
            q, k, v, bias=bias, key_mask=node_mask,
            dropout_rate=0.0 if deterministic else self.dropout, generator=generator)
        out = self.out_proj(ctx.to(self.compute_dtype).flatten(-2))
        out = self.norm(x + out)
        out = out * node_mask[..., None].to(out.dtype)
        if return_weights:
            return out, weights
        return out
