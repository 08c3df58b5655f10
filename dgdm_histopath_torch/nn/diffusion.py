"""The diffusion denoiser, held as ``diffusion.denoiser`` so that converted
checkpoints line up with the JAX package's parameter tree.

Only the denoiser's forward is ported; the noise schedule, ``add_noise``
and the pretrain objective come with the training slice.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm


def sinusoidal_time_embedding(t: torch.Tensor, dim: int = 128,
                              max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class DenoiserMLP(nn.Module):
    """Predicts noise from (x_t, timestep embedding); the model passes no
    conditioning, so the JAX module's optional ``cond_proj`` is not held."""

    def __init__(self, features: int, hidden: int = 0, time_embed_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = hidden or 4 * features
        self.time_embed_dim = time_embed_dim
        self.time_mlp1 = Dense(time_embed_dim, hidden, dtype=dtype)
        self.time_mlp2 = Dense(hidden, hidden, dtype=dtype)
        self.in_proj = Dense(features, hidden, dtype=dtype)
        self.norm1 = LayerNorm(hidden, dtype=dtype)
        self.mid_proj = Dense(hidden, hidden, dtype=dtype)
        self.norm2 = LayerNorm(hidden, dtype=dtype)
        self.out_proj = Dense(hidden, features, dtype=dtype)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_emb = sinusoidal_time_embedding(t, self.time_embed_dim)
        t_emb = self.time_mlp2(F.silu(self.time_mlp1(t_emb.to(x_t.dtype))))
        while t_emb.dim() < x_t.dim():          # per-graph embedding over nodes
            t_emb = t_emb[..., None, :]
        h = self.in_proj(x_t) + t_emb
        h = F.silu(self.norm1(h))
        h = F.silu(self.norm2(self.mid_proj(h)))
        return self.out_proj(h)


class DiffusionLayer(nn.Module):
    """Holder of the denoiser (the schedule comes with the training slice)."""

    def __init__(self, features: int, time_embed_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.denoiser = DenoiserMLP(features, time_embed_dim=time_embed_dim, dtype=dtype)
