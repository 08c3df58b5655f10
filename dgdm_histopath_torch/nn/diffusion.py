"""DiffusionLayer: forward noising and the noise-prediction network over
node features (counterpart of the JAX package's ``nn/diffusion.py``).

The denoiser is held as ``diffusion.denoiser`` so that converted checkpoints
line up with the JAX parameter tree. The schedule constants are buffers that
stay out of the ``state_dict`` (they follow from ``num_steps`` and
``schedule``), so a checkpoint holds parameters only. Training draws one
timestep per graph and noises all its nodes consistently; the layer returns
the noise it added, so the loss regresses the true corruption.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.diffusion import (
    DiffusionSchedule,
    add_noise,
    ddpm_sample,
    make_schedule,
    sinusoidal_time_embedding,
)
from .layers import Dense, LayerNorm

__all__ = ["DenoiserMLP", "DiffusionLayer", "sinusoidal_time_embedding"]


class DenoiserMLP(nn.Module):
    """Predicts noise from (x_t, timestep embedding); the model passes no
    conditioning, so the JAX module's optional ``cond_proj`` is not held."""

    def __init__(self, features: int, hidden: int = 0, time_embed_dim: int = 128,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = hidden or 4 * features
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.time_embed_dim = time_embed_dim
        self.time_mlp1 = Dense(time_embed_dim, hidden, **dt)
        self.time_mlp2 = Dense(hidden, hidden, **dt)
        self.in_proj = Dense(features, hidden, **dt)
        self.norm1 = LayerNorm(hidden, **dt)
        self.mid_proj = Dense(hidden, hidden, **dt)
        self.norm2 = LayerNorm(hidden, **dt)
        self.out_proj = Dense(hidden, features, **dt)

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
    """Forward noising + denoiser; the self-supervised objective of DGDM
    pretraining."""

    def __init__(self, features: int, num_steps: int = 10, schedule: str = "cosine",
                 time_embed_dim: int = 128, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_steps = num_steps
        self.compute_dtype = dtype
        for name, value in make_schedule(num_steps, schedule)._asdict().items():
            self.register_buffer(name, value, persistent=False)
        self.denoiser = DenoiserMLP(features, time_embed_dim=time_embed_dim, dtype=dtype,
                                    param_dtype=param_dtype)

    @property
    def constants(self) -> DiffusionSchedule:
        return DiffusionSchedule(*(getattr(self, f) for f in DiffusionSchedule._fields))

    def forward(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training forward on clean features x0 [..., N, F]: returns
        (predicted_noise, true_noise, t) with one timestep per graph. ``t``
        and ``noise`` are drawn from ``generator`` unless given."""
        if t is None:
            t = torch.randint(0, self.num_steps, x0.shape[:-2], generator=generator,
                              device=x0.device)
        x_t, noise = add_noise(self.constants, x0, t, noise=noise, generator=generator)
        return self.denoiser(x_t, t), noise, t

    def predict_noise(self, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.denoiser(x_t, t)

    @torch.no_grad()
    def sample(self, shape: Tuple[int, ...],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDPM ancestral sampling of ``shape`` [..., N, F] in f32, on the
        layer's device."""
        def denoise(x, t, cond):
            return self.denoiser(x.to(self.compute_dtype), t.expand(shape[:-2])).float()

        return ddpm_sample(self.constants, denoise, shape, generator=generator)
