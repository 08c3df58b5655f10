"""DDPM diffusion schedules and noising/denoising primitives (counterpart of
the JAX package's ``ops/diffusion.py``).

Linear, cosine and sigmoid beta schedules (the sigmoid one rescaled into
``[beta_start, beta_end]``), ``q(x_t | x_0)`` forward noising that returns
the noise it used, the sinusoidal timestep embedding, and DDPM ancestral
sampling as a Python loop. The schedule is computed once on the host in
float64 and held as float32 tensors.

Random draws never come from the global generator: every stochastic
function takes the drawn tensor or an explicit ``torch.Generator`` on the
device of its input.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class DiffusionSchedule(NamedTuple):
    """Precomputed schedule constants; every field is [T] float32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def make_schedule(num_steps: int, schedule: str = "cosine", beta_start: float = 1e-4,
                  beta_end: float = 2e-2) -> DiffusionSchedule:
    """Build a DDPM beta schedule (numpy float64 on the host, f32 CPU tensors out)."""
    if schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    elif schedule == "cosine":
        # Nichol & Dhariwal cosine alphas-cumprod; betas derived from ratios
        s = 0.008
        steps = np.arange(num_steps + 1, dtype=np.float64)
        f = np.cos(((steps / num_steps) + s) / (1 + s) * math.pi / 2) ** 2
        alphas_bar = f / f[0]
        betas = np.clip(1.0 - (alphas_bar[1:] / alphas_bar[:-1]), 0.0, 0.999)
    elif schedule == "sigmoid":
        t = np.linspace(-6.0, 6.0, num_steps, dtype=np.float64)
        sig = 1.0 / (1.0 + np.exp(-t))
        sig = (sig - sig.min()) / (sig.max() - sig.min())
        betas = beta_start + sig * (beta_end - beta_start)
    else:
        raise ValueError(f"unknown diffusion schedule: {schedule!r}")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / np.maximum(1.0 - alphas_cumprod, 1e-12))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return DiffusionSchedule(
        betas=f32(betas), alphas=f32(alphas), alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        posterior_variance=f32(posterior_variance))


def randn_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal draws of x's shape, dtype and device from ``generator``
    (drawn in f32, then cast)."""
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32).to(x.dtype)


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample x_t ~ q(x_t | x_0) and return (x_t, noise).

    ``t`` broadcasts against x0's leading axes (per-graph or per-node
    timesteps). ``noise`` is used when given, else drawn from ``generator``.
    """
    if noise is None:
        noise = randn_like(x0, generator)
    sa = schedule.sqrt_alphas_cumprod[t].to(x0.dtype)
    sb = schedule.sqrt_one_minus_alphas_cumprod[t].to(x0.dtype)
    while sa.dim() < x0.dim():
        sa, sb = sa[..., None], sb[..., None]
    return sa * x0 + sb * noise.to(x0.dtype), noise


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


def ddpm_sample_step(schedule: DiffusionSchedule, x_t: torch.Tensor,
                     predicted_noise: torch.Tensor, t: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ancestral DDPM reverse step, safe at t == 0."""
    beta = schedule.betas[t]
    alpha = schedule.alphas[t]
    sb = schedule.sqrt_one_minus_alphas_cumprod[t]
    mean = (x_t - (beta / sb) * predicted_noise) * torch.rsqrt(alpha)
    var = schedule.posterior_variance[t]
    if noise is None:
        noise = randn_like(x_t, generator)
    nonzero = (t > 0).to(x_t.dtype)
    return mean + nonzero * torch.sqrt(var.clamp_min(0.0)) * noise.to(x_t.dtype)


def ddpm_sample(schedule: DiffusionSchedule,
                denoise_fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                                     torch.Tensor],
                shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full ancestral sampling from t = T-1 down to 0, in f32 on the
    schedule's device; ``denoise_fn(x_t, t, cond) -> predicted noise`` with
    a 0-d timestep ``t``."""
    device = schedule.betas.device
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    for step in range(schedule.num_steps - 1, -1, -1):
        t = torch.tensor(step, device=device)
        x = ddpm_sample_step(schedule, x, denoise_fn(x, t, cond), t, generator=generator)
    return x
