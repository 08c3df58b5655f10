"""Model presets: the published DGDM family configurations, built on the
card by default."""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.layers import init_parameters
from ..utils.device import resolve_device
from .dgdm import DGDMModel

PRESETS = {
    "dgdm-base": dict(
        node_features=768, hidden_dims=(512, 256, 128), num_diffusion_steps=10,
        attention_heads=8, dropout=0.1, graph_layers=4,
        use_spatial_attention=True, use_hierarchical=True,
        diffusion_schedule="cosine", pooling="attention"),
    # windowed+banded by default at its 2048-node buckets (pass
    # spatial_window=None, graph_window=None for the dense semantics)
    "dgdm-large": dict(
        node_features=1024, hidden_dims=(768, 512, 256, 128),
        num_diffusion_steps=20, attention_heads=16, dropout=0.15,
        graph_layers=6, use_spatial_attention=True, use_hierarchical=True,
        diffusion_schedule="cosine", pooling="attention",
        spatial_window=128, graph_window=128),
    "dgdm-clinical": dict(
        node_features=768, hidden_dims=(512, 256, 128), num_diffusion_steps=15,
        attention_heads=8, dropout=0.1, graph_layers=5,
        use_spatial_attention=True, use_hierarchical=True,
        diffusion_schedule="cosine", pooling="attention",
        label_note="multi-cancer grading"),
    "dgdm-small": dict(
        node_features=384, hidden_dims=(256, 128), num_diffusion_steps=5,
        attention_heads=8, dropout=0.1, graph_layers=2,
        use_spatial_attention=True, use_hierarchical=False,
        diffusion_schedule="cosine", pooling="attention"),
}

# buckets of at least this many nodes default to windowed+banded compute
WINDOWED_DEFAULT_MIN_NODES = 2048
DEFAULT_WINDOW = 128


def default_window_policy(max_nodes: int):
    """The default (spatial_window, graph_window) for a node bucket; ``None``
    means dense (all-pairs attention, full kNN message passing)."""
    if max_nodes >= WINDOWED_DEFAULT_MIN_NODES:
        return DEFAULT_WINDOW, DEFAULT_WINDOW
    return None, None


def create_model(preset: str = "dgdm-base", num_classes: Optional[int] = None,
                 regression_targets: int = 0, device=None, seed: int = 0,
                 **overrides) -> DGDMModel:
    """Build a preset with seeded parameters on ``device`` (``None`` means
    ``"cuda"``; raises when no card is present) in eval mode."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; options: {sorted(PRESETS)}")
    dev = resolve_device(device)
    cfg = {k: v for k, v in PRESETS[preset].items() if k != "label_note"}
    cfg.update(overrides)
    model = DGDMModel(num_classes=num_classes, regression_targets=regression_targets, **cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def list_presets():
    return sorted(PRESETS)
