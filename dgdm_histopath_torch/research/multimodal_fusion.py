"""Multimodal fusion of histology with clinical or genomic modalities
(counterpart of the JAX package's ``research/multimodal_fusion.py``): modules
over fixed-size modality embeddings, missing modalities handled by masks, and
a small fusion benchmark."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.attention import CrossModalAttention, MultiHeadAttention
from ..nn.layers import Dense, LayerNorm, draw_into, dropout, gelu, init_parameters
from ..utils.device import resolve_device

__all__ = ["AdaptiveModalityEncoder", "CrossModalAttentionFusion",
           "HierarchicalModalityFusion", "UncertaintyAwareFusion",
           "benchmark_fusion_strategies"]


class AdaptiveModalityEncoder(nn.Module):
    """Per-modality MLPs into a shared space (``{name}_in`` Dense to
    2 x embed_dim, tanh-GELU, dropout, ``{name}_out``, ``{name}_norm``), with a
    learned ``{name}_null`` embedding (N(0, 0.02) at init) standing in where a
    modality is missing. inputs[name] [B, D_name], present[name] [B] bool ->
    tokens [B, M, embed_dim], modalities in sorted order."""

    def __init__(self, modality_dims: Dict[str, int], embed_dim: int = 128,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = sorted(modality_dims)
        self.dropout, self.compute_dtype = dropout, dtype
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        for name in self.names:
            self.add_module(f"{name}_in", Dense(modality_dims[name], 2 * embed_dim, **dt))
            self.add_module(f"{name}_out", Dense(2 * embed_dim, embed_dim, **dt))
            self.add_module(f"{name}_norm", LayerNorm(embed_dim, **dt))
            self.register_parameter(f"{name}_null", nn.Parameter(
                torch.zeros(embed_dim, dtype=param_dtype)))

    def draw_parameters(self, generator: torch.Generator) -> None:
        for name in self.names:
            draw_into(getattr(self, f"{name}_null"),
                      lambda t: t.normal_(0.0, 0.02, generator=generator))

    def forward(self, inputs: Dict[str, torch.Tensor],
                present: Optional[Dict[str, torch.Tensor]] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = []
        for name in self.names:
            h = gelu(getattr(self, f"{name}_in")(inputs[name].to(self.compute_dtype)))
            if not deterministic:
                h = dropout(h, self.dropout, generator)
            h = getattr(self, f"{name}_norm")(getattr(self, f"{name}_out")(h))
            if present is not None and name in present:
                m = present[name][..., None].to(h.dtype)
                h = m * h + (1 - m) * getattr(self, f"{name}_null").to(h.dtype)
            tokens.append(h)
        return torch.stack(tokens, dim=1)


class CrossModalAttentionFusion(nn.Module):
    """The primary (histology) token cross-attends the modality tokens
    through ``num_layers`` ``CrossModalAttention`` blocks (``xmodal{i}``);
    ``fuse`` projects [primary, attended]. primary [B, E], tokens [B, M, E]
    -> [B, E]."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, num_layers: int = 2,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        for i in range(num_layers):
            self.add_module(f"xmodal{i}", CrossModalAttention(embed_dim, num_heads,
                                                              dropout=dropout, **dt))
        self.fuse = Dense(2 * embed_dim, embed_dim, **dt)

    def forward(self, primary: torch.Tensor, modality_tokens: torch.Tensor,
                modality_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = primary[:, None, :]
        for i in range(self.num_layers):
            h = getattr(self, f"xmodal{i}")(h, modality_tokens, context_mask=modality_mask,
                                            deterministic=deterministic, generator=generator)
        return self.fuse(torch.cat([primary, h[:, 0]], dim=-1))


class UncertaintyAwareFusion(nn.Module):
    """Precision-weighted averaging of the modality tokens: each token
    predicts a log-variance (``log_var``), the weights are the normalized
    precisions exp(-log_var) (f32, masked). tokens [B, M, E] ->
    ``{"fused" [B, E], "weights" [B, M], "log_var" [B, M]}``."""

    def __init__(self, embed_dim: int = 128, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.log_var = Dense(embed_dim, 1, dtype=dtype, param_dtype=param_dtype)

    def forward(self, modality_tokens: torch.Tensor,
                modality_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        log_var = self.log_var(modality_tokens)[..., 0]
        precision = torch.exp(-log_var.float())
        if modality_mask is not None:
            precision = precision * modality_mask.to(precision.dtype)
        weights = precision / precision.sum(-1, keepdim=True).clamp_min(1e-8)
        fused = torch.einsum("bm,bme->be", weights.to(modality_tokens.dtype), modality_tokens)
        return {"fused": fused, "weights": weights, "log_var": log_var}


class HierarchicalModalityFusion(nn.Module):
    """Two-stage fusion: attention within each group of tokens
    (``group_{name}``, groups in sorted order), the mean of each, attention
    across the group vectors (``across``), their mean, and ``out``.
    groups: name -> token indices; tokens [B, M, E] -> [B, E]."""

    def __init__(self, groups: Dict[str, Sequence[int]], embed_dim: int = 128,
                 num_heads: int = 4, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = {name: list(idx) for name, idx in sorted(groups.items())}
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        for name in self.groups:
            self.add_module(f"group_{name}", MultiHeadAttention(embed_dim, num_heads, **dt))
        self.across = MultiHeadAttention(embed_dim, num_heads, **dt)
        self.out = Dense(embed_dim, embed_dim, **dt)

    def forward(self, modality_tokens: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rand = dict(deterministic=deterministic, generator=generator)
        pooled = []
        for name, idx in self.groups.items():
            toks = modality_tokens[:, torch.as_tensor(idx, device=modality_tokens.device)]
            pooled.append(getattr(self, f"group_{name}")(toks, **rand).mean(1))
        fused = self.across(torch.stack(pooled, dim=1), **rand).mean(1)
        return self.out(fused)


def fusion_data(generator: torch.Generator, batch: int, embed_dim: int, device):
    """The benchmark's synthetic modalities: a latent [16·batch, E], histology
    = latent + 0.1 noise, genomic = latent @ (0.1 · a random [E, E]), labels
    = whether the latent's sum is positive."""
    latent = torch.randn(batch * 16, embed_dim, generator=generator, device=device)
    noise = torch.randn(latent.shape, generator=generator, device=device)
    mix = torch.randn(embed_dim, embed_dim, generator=generator, device=device)
    inputs = {"histology": latent + 0.1 * noise, "genomic": latent @ mix * 0.1}
    return inputs, (latent.sum(-1) > 0).long()


def benchmark_fusion_strategies(seed: int = 0, batch: int = 8, embed_dim: int = 64,
                                device=None, data=None, init: Optional[dict] = None
                                ) -> Dict[str, Dict[str, float]]:
    """Cross-attention fusion against uncertainty-weighted fusion on
    synthetic correlated modalities: each strategy's cross-entropy before and
    after 20 Adam steps (lr 1e-3, optax ``adam``'s update) of its encoder,
    fuser and a linear head. A smoke-level comparison, not a paper result.

    The data comes from a ``torch.Generator`` on ``device`` (``None`` means
    ``"cuda"``) seeded with ``seed``; each strategy's parameters from a CPU
    generator seeded with ``seed`` (``init_parameters``, the head 0.1 · N(0, 1)),
    so both start from the same encoder. ``data`` = (inputs, labels) and
    ``init`` = strategy -> (encoder state, fuser state, head [E, 2]) replace
    the draws, so that another run's data and parameters can be replayed."""
    from ..training.trainer import OptaxAdamW

    dev = resolve_device(device)
    if data is None:
        data = fusion_data(torch.Generator(dev).manual_seed(seed), batch, embed_dim, dev)
    inputs = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
              for k, v in data[0].items()}
    onehot = torch.nn.functional.one_hot(torch.as_tensor(data[1]).long(), 2).float().to(dev)
    results = {}
    for name in ("cross_attention", "uncertainty"):
        encoder = AdaptiveModalityEncoder({"histology": embed_dim, "genomic": embed_dim},
                                          embed_dim=embed_dim)
        fuser = (CrossModalAttentionFusion(embed_dim, num_heads=4, num_layers=1)
                 if name == "cross_attention" else UncertaintyAwareFusion(embed_dim))
        if init is None:
            cpu_gen = torch.Generator().manual_seed(seed)
            init_parameters(encoder, cpu_gen)
            init_parameters(fuser, cpu_gen)
            head = torch.randn(embed_dim, 2, generator=cpu_gen) * 0.1
        else:
            enc_state, fuse_state, head = init[name]
            encoder.load_state_dict(enc_state)
            fuser.load_state_dict(fuse_state)
        encoder, fuser = encoder.to(dev), fuser.to(dev)
        head = torch.tensor(np.asarray(head), dtype=torch.float32, device=dev,
                            requires_grad=True)

        def loss_of():
            toks = encoder(inputs)
            if name == "cross_attention":
                fused = fuser(toks[:, 0], toks)
            else:
                fused = fuser(toks)["fused"]
            return -(onehot * torch.log_softmax(fused @ head, dim=-1)).sum(-1).mean()

        params = list(encoder.parameters()) + list(fuser.parameters()) + [head]
        opt = OptaxAdamW(params, lr=1e-3, weight_decay=0.0)
        with torch.no_grad():
            loss0 = float(loss_of())
        for _ in range(20):
            opt.zero_grad(set_to_none=True)
            loss_of().backward()
            opt.step()
        with torch.no_grad():
            results[name] = {"initial_loss": loss0, "final_loss": float(loss_of())}
    return results
