"""Masked dense attention, ``MultiHeadAttention``, ``CrossModalAttention``,
2-D positional encoding and ``SpatialAttention``.

Counterpart of the JAX package's ``nn/attention.py``. ``SpatialAttention``
has the reference's three routes: flash (``use_flash=True``: the CUDA kernels
of ``ops/kernels/flash_spatial.py``, no [N, N] buffer), windowed
(``window_size=W``: each W-block of queries attends to its own and the two
adjacent key blocks, the ends wrapping around) and dense. ``DGDMModel`` sets
the window (``spatial_window``) but never ``use_flash``, and returning the
weights forces the dense route, as in the reference. Softmax math is f32;
``traffic_dtype`` sets the storage type of the logits and weights buffers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.kernels.flash_spatial import distance_bias, flash_spatial_attention
from .layers import Dense, DenseGeneral, LayerNorm, dropout, gelu


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    traffic_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked SDPA. q [..., Lq, H, D], k/v [..., Lk, H, D].

    Returns (out [..., Lq, H, D], weights [..., H, Lq, Lk]). Query rows
    with no valid key come out as zeros. ``dropout_rate > 0`` drops
    attention weights with draws from ``generator``. ``traffic_dtype``
    (default f32) is the type the QK^T logits and the weights are stored in:
    one rounding of each, the softmax between them stays f32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    raw = torch.einsum("...qhd,...khd->...hqk", q, k)
    if traffic_dtype is not None:
        raw = raw.to(traffic_dtype)
    logits = raw.float() * scale
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
    if traffic_dtype is not None:
        weights = weights.to(traffic_dtype)
    out = torch.einsum("...hqk,...khd->...qhd", weights.to(v.dtype), v)
    return out, weights


class MultiHeadAttention(nn.Module):
    """Dense multi-head attention with key masking, an optional additive
    bias and the weights on request (the JAX package's
    ``MultiHeadAttention``): per-head q / k / v projections (flax
    ``DenseGeneral`` to ``(heads, head_dim)``), :func:`scaled_dot_product_attention`,
    and ``out_proj`` over ``(heads, head_dim)``.

    flax infers the input widths; here the query's is ``q_features`` and the
    key's and value's ``kv_features`` (both ``embed_dim`` unless given)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 q_features: Optional[int] = None, kv_features: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        q_in = q_features or embed_dim
        kv_in = kv_features or embed_dim
        self.q_proj = DenseGeneral(q_in, embed_dim, **dt)
        self.k_proj = DenseGeneral(kv_in, embed_dim, **dt)
        self.v_proj = DenseGeneral(kv_in, embed_dim, **dt)
        self.out_proj = DenseGeneral(embed_dim, embed_dim, **dt)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, deterministic: bool = True,
                return_weights: bool = False,
                generator: Optional[torch.Generator] = None):
        """query [B, Lq, Dq], key / value [B, Lk, Dkv] (the query where not
        given), key_mask [B, Lk] bool, bias [B, H or 1, Lq, Lk]. Returns
        [B, Lq, embed_dim], and the weights [B, H, Lq, Lk] with
        ``return_weights``. When not deterministic, dropout falls on the
        weights, drawn from ``generator``."""
        key = query if key is None else key
        value = key if value is None else value
        heads = (self.num_heads, self.embed_dim // self.num_heads)
        q = self.q_proj(query).unflatten(-1, heads)
        k = self.k_proj(key).unflatten(-1, heads)
        v = self.v_proj(value).unflatten(-1, heads)
        out, weights = scaled_dot_product_attention(
            q, k, v, bias=bias, key_mask=key_mask,
            dropout_rate=0.0 if deterministic else self.dropout, generator=generator)
        out = self.out_proj(out.flatten(-2))
        if return_weights:
            return out, weights
        return out


class CrossModalAttention(nn.Module):
    """Cross-attention to a context, self-attention, then a tanh-GELU FFN,
    each followed by a residual LayerNorm (the JAX package's
    ``CrossModalAttention``). x [B, Lx, embed_dim]; the context's width is
    ``context_features`` (``embed_dim`` unless given)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 context_features: Optional[int] = None):
        super().__init__()
        self.dropout = dropout
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, dropout,
                                             kv_features=context_features, **dt)
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout, **dt)
        self.norm_cross = LayerNorm(embed_dim, **dt)
        self.norm_self = LayerNorm(embed_dim, **dt)
        hidden = int(embed_dim * mlp_ratio)
        self.ff1 = Dense(embed_dim, hidden, **dt)
        self.ff2 = Dense(hidden, embed_dim, **dt)
        self.norm_ff = LayerNorm(embed_dim, **dt)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rand = dict(deterministic=deterministic, generator=generator)
        h = self.norm_cross(x + self.cross_attn(x, context, context, key_mask=context_mask,
                                                **rand))
        h = self.norm_self(h + self.self_attn(h, key_mask=x_mask, **rand))
        ff = gelu(self.ff1(h))
        if not deterministic:
            ff = dropout(ff, self.dropout, generator)
        out = self.norm_ff(h + self.ff2(ff))
        if x_mask is not None:
            out = out * x_mask[..., None].to(out.dtype)
        return out


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
    ``-distance / tau`` bias, masked and batched.

    Routes, with the reference's eligibility rules (:meth:`route`):

    - ``"flash"``: wanted by ``use_flash`` (or, when deterministic, by
      N >= ``flash_auto_min_nodes``, off by default); needs N % 128 == 0, no
      returned weights and no active dropout (the kernels have none). Runs
      ``flash_spatial_attention``; wins over the window.
    - ``"window"``: ``window_size=W`` with N % W == 0, N // W >= 3 and no
      returned weights. Block-local attention along the node order: each
      W-block attends to the previous, its own and the next block (3W keys);
      block 0's previous block is the last one and the last block's next is
      block 0 (the ends roll around). Meaningful when nodes are in
      spatial-sort (Morton) order, where the bias suppresses the wrapped
      blocks. An approximation of all-pairs attention.
    - ``"dense"``: everything else, with the [B, H, N, N] weights.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 distance_tau: float = 0.1, use_flash: bool = False,
                 flash_auto_min_nodes: int = 1 << 30,
                 window_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 traffic_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.distance_tau = distance_tau
        self.use_flash = use_flash
        self.flash_auto_min_nodes = flash_auto_min_nodes
        self.window_size = window_size
        self.traffic_dtype = traffic_dtype
        self.compute_dtype = dtype
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.pos_proj = Dense(embed_dim, embed_dim, **dt)
        self.q_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.k_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.v_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.out_proj = DenseGeneral(embed_dim, embed_dim, **dt)
        self.norm = LayerNorm(embed_dim, **dt)

    def route(self, n: int, deterministic: bool = True,
              return_weights: bool = False) -> str:
        """``"flash"``, ``"window"`` or ``"dense"`` for a bucket of n nodes."""
        want_flash = self.use_flash or (deterministic and n >= self.flash_auto_min_nodes)
        no_dropout = deterministic or self.dropout == 0.0
        if want_flash and not return_weights and n % 128 == 0 and no_dropout:
            return "flash"
        w = self.window_size
        if w is not None and not return_weights and n % (w or 1) == 0 and n // w >= 3:
            return "window"
        return "dense"

    def _windowed(self, q, k, v, posf, node_mask, rate, generator):
        w = self.window_size
        lead, n = q.shape[:-3], q.shape[-3]
        nb = n // w
        blk = len(lead)                       # the axis of the nb blocks

        def blocks(t):                        # [.., N, ...] -> [.., nb, w, ...]
            return t.reshape(*lead, nb, w, *t.shape[blk + 1:])

        def widen(t):                         # previous + own + next block
            return torch.cat([torch.roll(t, 1, blk), t, torch.roll(t, -1, blk)], dim=blk + 1)

        qpos = blocks(posf)
        ctx, _ = scaled_dot_product_attention(
            blocks(q), widen(blocks(k)), widen(blocks(v)),
            bias=distance_bias(qpos, widen(qpos), self.distance_tau)[..., None, :, :],
            key_mask=widen(blocks(node_mask)), dropout_rate=rate, generator=generator,
            traffic_dtype=self.traffic_dtype)
        return ctx.reshape(*lead, n, *ctx.shape[blk + 2:])

    def forward(self, x: torch.Tensor, pos: torch.Tensor, node_mask: torch.Tensor,
                return_weights: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, keys=None):
        """x [B, N, D], pos [B, N, 2], node_mask [B, N] bool. When not
        deterministic, dropout falls on the attention weights.

        ``keys``: where the queries' N rows are a block of a larger graph
        (``parallel/sp.py``), a function taking a per-node tensor of this
        block [B, N, ...] to that of every key [B, N_k, ...]; the keys'
        projections, positions and mask go through it, and the route must be
        dense."""
        pos_enc = sinusoidal_position_encoding_2d(pos, self.embed_dim).to(x.dtype)
        h = x + self.pos_proj(pos_enc)
        heads = (self.num_heads, self.embed_dim // self.num_heads)
        if keys is None:
            keys = lambda t: t  # noqa: E731 - every key is a query row
        q = self.q_proj(h).unflatten(-1, heads)
        k = keys(self.k_proj(h)).unflatten(-1, heads)
        v = keys(self.v_proj(h)).unflatten(-1, heads)
        posf = pos.float()
        kpos, key_mask = keys(posf), keys(node_mask)
        rate = 0.0 if deterministic else self.dropout
        route = self.route(k.shape[-3], deterministic, return_weights)
        if route != "dense" and k.shape[-3] != q.shape[-3]:
            raise ValueError(f"the {route} route attends within one graph's rows; a block "
                             f"of {q.shape[-3]} queries over {k.shape[-3]} keys takes dense")
        weights = None
        if route == "flash":
            ctx = flash_spatial_attention(q, k, v, posf, node_mask, tau=self.distance_tau)
        elif route == "window":
            ctx = self._windowed(q, k, v, posf, node_mask, rate, generator)
        else:
            ctx, weights = scaled_dot_product_attention(
                q, k, v, bias=distance_bias(posf, kpos, self.distance_tau)[..., None, :, :],
                key_mask=key_mask, dropout_rate=rate, generator=generator,
                traffic_dtype=self.traffic_dtype)
        out = self.out_proj(ctx.to(self.compute_dtype).flatten(-2))
        out = self.norm(x + out)
        out = out * node_mask[..., None].to(out.dtype)
        if return_weights:
            return out, weights
        return out
