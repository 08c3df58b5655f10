"""Prediction heads (classification, regression, survival, multi-task) and
their losses: cross entropy, Cox partial likelihood, discrete-time survival
NLL, the multi-task uncertainty weighting (counterpart of the JAX package's
``models/decoders.py``). Losses are f32."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, LayerNorm, dropout, gelu


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """logits [B, C], labels [B] int -> mean (or class-weighted mean) CE."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    per_sample = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    if class_weights is not None:
        w = class_weights.float()[labels.long()]
        return (per_sample * w).sum() / w.sum().clamp_min(1e-8)
    return per_sample.mean()


def cox_partial_likelihood(risk: torch.Tensor, time: torch.Tensor, event: torch.Tensor,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Breslow-approximation Cox partial likelihood. risk [B] log-hazards,
    time [B], event [B] in {0, 1}; the risk set of sample i is
    {j : time_j >= time_i}, a [B, B] mask. ``valid`` [B] excludes filler
    rows from the risk sets and the event sum."""
    risk = risk.float()
    at_risk = time[None, :] >= time[:, None]
    ev = event.float()
    if valid is not None:
        v = valid.bool()
        at_risk = at_risk & v[None, :] & v[:, None]
        ev = ev * v.float()
    masked = torch.where(at_risk, risk[None, :],
                         torch.full_like(risk, torch.finfo(torch.float32).min)[None, :])
    per_event = (risk - torch.logsumexp(masked, dim=-1)) * ev
    return -per_event.sum() / ev.sum().clamp_min(1.0)


def discrete_survival_loss(hazard_logits: torch.Tensor, interval: torch.Tensor,
                           event: torch.Tensor,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Discrete-time survival NLL. hazard_logits [B, T], interval [B] int
    (clipped into [0, T)), event [B] in {0, 1}; ``valid`` [B] excludes
    filler rows."""
    steps = hazard_logits.shape[-1]
    log_h = F.logsigmoid(hazard_logits.float())
    log_1mh = F.logsigmoid(-hazard_logits.float())
    interval = interval.long().clamp(0, steps - 1)
    before = (torch.arange(steps, device=interval.device)[None, :]
              < interval[:, None]).float()
    survive_term = (log_1mh * before).sum(-1)
    at = torch.gather(log_h, -1, interval[:, None])[:, 0]
    at_1mh = torch.gather(log_1mh, -1, interval[:, None])[:, 0]
    ev = event.float()
    loglik = survive_term + ev * at + (1.0 - ev) * at_1mh
    if valid is None:
        return -loglik.mean()
    v = valid.float()
    return -(loglik * v).sum() / v.sum().clamp_min(1.0)


class _MLPHead(nn.Module):
    """Trunk of ``hidden{i}`` Dense + ``hidden{i}_norm`` LayerNorm + gelu +
    dropout (when not deterministic)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 dropout: float, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.n_hidden = len(hidden_dims)
        self.dropout = dropout
        prev = in_features
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"hidden{i}", Dense(prev, dim, **self.dt))
            self.add_module(f"hidden{i}_norm", LayerNorm(dim, **self.dt))
            prev = dim
        self.trunk_features = prev

    def trunk(self, x: torch.Tensor, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.n_hidden):
            h = gelu(getattr(self, f"hidden{i}_norm")(getattr(self, f"hidden{i}")(h)))
            if not deterministic:
                h = dropout(h, self.dropout, generator)
        return h


class ClassificationHead(_MLPHead):
    def __init__(self, in_features: int, num_classes: int,
                 hidden_dims: Sequence[int] = (128,), dropout: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dropout, dtype, param_dtype)
        self.logits = Dense(self.trunk_features, num_classes, **self.dt)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.logits(self.trunk(x, deterministic, generator))


class RegressionHead(_MLPHead):
    """Mean (and, with ``predict_uncertainty``, log-variance) outputs."""

    def __init__(self, in_features: int, num_targets: int = 1,
                 hidden_dims: Sequence[int] = (128,), dropout: float = 0.0,
                 predict_uncertainty: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dropout, dtype, param_dtype)
        self.mean = Dense(self.trunk_features, num_targets, **self.dt)
        self.log_var = (Dense(self.trunk_features, num_targets, **self.dt)
                        if predict_uncertainty else None)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        h = self.trunk(x, deterministic, generator)
        out = {"mean": self.mean(h)}
        if self.log_var is not None:
            out["log_var"] = self.log_var(h)
        return out


class SurvivalHead(_MLPHead):
    """Cox log-hazard (``risk``) or discrete-time hazards + survival curve."""

    def __init__(self, in_features: int, mode: str = "cox", num_intervals: int = 10,
                 hidden_dims: Sequence[int] = (128,), dropout: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__(in_features, hidden_dims, dropout, dtype, param_dtype)
        if mode not in ("cox", "discrete"):
            raise ValueError("survival mode must be cox|discrete")
        self.mode = mode
        if mode == "cox":
            self.risk = Dense(self.trunk_features, 1, **self.dt)
        else:
            self.hazards = Dense(self.trunk_features, num_intervals, **self.dt)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        h = self.trunk(x, deterministic, generator)
        if self.mode == "cox":
            return {"risk": self.risk(h)[..., 0]}
        hazards = self.hazards(h)
        surv = torch.cumprod(torch.sigmoid(-hazards.float()), dim=-1)
        return {"hazard_logits": hazards, "survival": surv}


class MultiTaskHead(nn.Module):
    """A shared trunk (``trunk{i}`` Denses, each followed by tanh-GELU), one
    head per task (``head_{name}``: a ``ClassificationHead`` or a
    ``RegressionHead``) and the learned per-task log-variances ``log_vars``
    (f32, zeros at init) of Kendall et al.'s weighting.

    ``task_configs``: name -> ``{"type": "classification", "num_classes"}``
    or ``{"type": "regression", "num_targets", "loss_type"}``; the
    ``loss_type`` is the regression loss's, which no forward reads."""

    def __init__(self, in_features: int, task_configs: Dict[str, dict],
                 trunk_dims: Sequence[int] = (256,), dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.task_configs = dict(task_configs)
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.n_trunk = len(trunk_dims)
        prev = in_features
        for i, dim in enumerate(trunk_dims):
            self.add_module(f"trunk{i}", Dense(prev, dim, **dt))
            prev = dim
        for name, cfg in self.task_configs.items():
            kind = cfg.get("type", "classification")
            if kind == "classification":
                head = ClassificationHead(prev, cfg.get("num_classes", 2), dropout=dropout,
                                          **dt)
            elif kind == "regression":
                head = RegressionHead(prev, cfg.get("num_targets", 1), dropout=dropout, **dt)
            else:
                raise ValueError(f"unknown task type {kind!r}")
            self.add_module(f"head_{name}", head)
        self.log_vars = nn.Parameter(torch.zeros(len(self.task_configs), dtype=torch.float32))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        h = x
        for i in range(self.n_trunk):
            h = gelu(getattr(self, f"trunk{i}")(h))
        return {name: getattr(self, f"head_{name}")(h, deterministic, generator)
                for name in self.task_configs}

    def combined_loss(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ_i exp(-log_var_i) · loss_i + log_var_i / 2, in task order, f32."""
        total = torch.zeros((), dtype=torch.float32, device=self.log_vars.device)
        for i, name in enumerate(self.task_configs):
            lv = self.log_vars[i]
            total = total + torch.exp(-lv) * losses[name] + 0.5 * lv
        return total
