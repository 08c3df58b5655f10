"""Experimental graph modules (counterpart of the JAX package's
``research/novel_algorithms.py``): phase-modulated graph diffusion, attention
over scales, and learned edge re-weighting. The neighbor gathers are the
``gather_rows`` kernel on the card; each is followed by its own masked sum,
as in the JAX package (folding the two into ``gather_agg`` would round
otherwise)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.attention import MultiHeadAttention
from ..nn.layers import Dense, LayerNorm, draw_into
from ..ops.graph import gather_neighbors, masked_neighbor_sum, masked_softmax

__all__ = ["AdaptiveGraphTopology", "HierarchicalAttentionFusion",
           "PhaseModulatedGraphDiffusion", "QuantumGraphDiffusion"]


class PhaseModulatedGraphDiffusion(nn.Module):
    """Graph diffusion with a learned per-channel phase rotation: each round
    rotates the (first half, second half) channel pairs by ``phase{r}``
    (drawn from U[0, 0.1)), then averages each node with the mean of its
    valid neighbors (``x / 2 + Σ_nbr / (2 · max(deg, 1))``) and applies
    ``norm{r}``. x [B, N, in_features] (projected by ``in_proj`` where
    ``in_features != features``) -> [B, N, features], zero on padding."""

    def __init__(self, features: int, num_rounds: int = 3,
                 in_features: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.num_rounds = features, num_rounds
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        if in_features is not None and in_features != features:
            self.in_proj = Dense(in_features, features, **dt)
        for r in range(num_rounds):
            self.register_parameter(f"phase{r}", nn.Parameter(
                torch.zeros(features // 2, dtype=param_dtype)))
            self.add_module(f"norm{r}", LayerNorm(features, **dt))

    def draw_parameters(self, generator: torch.Generator) -> None:
        for r in range(self.num_rounds):
            draw_into(getattr(self, f"phase{r}"),
                      lambda t: t.uniform_(0.0, 0.1, generator=generator))

    def forward(self, x: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.features:
            x = self.in_proj(x)
        half = self.features // 2
        deg = nbr_mask.sum(-1, keepdim=True).clamp_min(1).to(x.dtype)
        for r in range(self.num_rounds):
            theta = getattr(self, f"phase{r}").to(x.dtype)
            a, b = x[..., :half], x[..., half:2 * half]
            cos, sin = torch.cos(theta), torch.sin(theta)
            x = torch.cat([a * cos - b * sin, a * sin + b * cos, x[..., 2 * half:]], dim=-1)
            agg = masked_neighbor_sum(gather_neighbors(x, nbr_idx), nbr_mask)
            x = 0.5 * x + 0.5 * agg / deg
            x = getattr(self, f"norm{r}")(x)
        return x * node_mask[..., None].to(x.dtype)


# the name the reference gives it
QuantumGraphDiffusion = PhaseModulatedGraphDiffusion


class HierarchicalAttentionFusion(nn.Module):
    """Fuse per-scale node embeddings: attention across the S scales of
    each node (``scale_attn``), a learned gate per scale (softmax over S in
    f32), the gated sum. A list of S [B, N, in_features] -> [B, N, features],
    zero on padding."""

    def __init__(self, features: int, num_heads: int = 4,
                 in_features: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.scale_attn = MultiHeadAttention(features, num_heads, q_features=in_features,
                                             kv_features=in_features, **dt)
        self.gate = Dense(features, 1, **dt)

    def forward(self, scale_embeddings: Sequence[torch.Tensor], node_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        stacked = torch.stack(list(scale_embeddings), dim=2)        # [B, N, S, F]
        b, n, s, f = stacked.shape
        mixed = self.scale_attn(stacked.reshape(b * n, s, f), deterministic=deterministic,
                                generator=generator).reshape(b, n, s, -1)
        gates = torch.softmax(self.gate(mixed)[..., 0].float(), dim=-1)
        fused = torch.einsum("bns,bnsf->bnf", gates.to(stacked.dtype), mixed)
        return fused * node_mask[..., None].to(fused.dtype)


class AdaptiveGraphTopology(nn.Module):
    """Learned edge re-weighting over the existing candidate neighbors:
    scores ``h_n · h_k / sqrt(features)`` of the projected features
    (``proj``), a masked softmax at ``temperature``, and the slots whose
    weight exceeds 1 / (2K) kept. Returns ``{"edge_weights", "nbr_mask",
    "scores"}`` ([B, N, K]; the new mask a subset of the old)."""

    def __init__(self, in_features: int, features: int, temperature: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.temperature = features, temperature
        self.proj = Dense(in_features, features, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.proj(x)
        nbr = gather_neighbors(h, nbr_idx)                           # [B, N, K, F]
        score = torch.einsum("...nf,...nkf->...nk", h, nbr).float()
        score = score / score.new_tensor(float(np.sqrt(np.float32(self.features))))
        weights = masked_softmax(score / self.temperature, nbr_mask)
        keep = (weights > 1.0 / (2.0 * nbr_mask.shape[-1])) & nbr_mask
        return {"edge_weights": weights, "nbr_mask": keep, "scores": score}
