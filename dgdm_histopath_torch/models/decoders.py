"""Prediction heads (forward only): classification, regression, survival.
Losses come with the training slice."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, gelu


class _MLPHead(nn.Module):
    """Trunk of ``hidden{i}`` Dense + ``hidden{i}_norm`` LayerNorm + gelu."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        prev = in_features
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"hidden{i}", Dense(prev, dim, dtype=dtype))
            self.add_module(f"hidden{i}_norm", LayerNorm(dim, dtype=dtype))
            prev = dim
        self.trunk_features = prev

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_hidden):
            h = gelu(getattr(self, f"hidden{i}_norm")(getattr(self, f"hidden{i}")(h)))
        return h


class ClassificationHead(_MLPHead):
    def __init__(self, in_features: int, num_classes: int,
                 hidden_dims: Sequence[int] = (128,), dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dtype)
        self.logits = Dense(self.trunk_features, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(self.trunk(x))


class RegressionHead(_MLPHead):
    """Mean (and, with ``predict_uncertainty``, log-variance) outputs."""

    def __init__(self, in_features: int, num_targets: int = 1,
                 hidden_dims: Sequence[int] = (128,),
                 predict_uncertainty: bool = False, dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dtype)
        self.mean = Dense(self.trunk_features, num_targets, dtype=dtype)
        self.log_var = (Dense(self.trunk_features, num_targets, dtype=dtype)
                        if predict_uncertainty else None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.trunk(x)
        out = {"mean": self.mean(h)}
        if self.log_var is not None:
            out["log_var"] = self.log_var(h)
        return out


class SurvivalHead(_MLPHead):
    """Cox log-hazard (``risk``) or discrete-time hazards + survival curve."""

    def __init__(self, in_features: int, mode: str = "cox", num_intervals: int = 10,
                 hidden_dims: Sequence[int] = (128,), dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dtype)
        if mode not in ("cox", "discrete"):
            raise ValueError("survival mode must be cox|discrete")
        self.mode = mode
        if mode == "cox":
            self.risk = Dense(self.trunk_features, 1, dtype=dtype)
        else:
            self.hazards = Dense(self.trunk_features, num_intervals, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.trunk(x)
        if self.mode == "cox":
            return {"risk": self.risk(h)[..., 0]}
        hazards = self.hazards(h)
        surv = torch.cumprod(torch.sigmoid(-hazards.float()), dim=-1)
        return {"hazard_logits": hazards, "survival": surv}
