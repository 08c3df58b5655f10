"""Adversarial robustness of a DGDM model: attacks on the node features, input
defenses, and clean / attacked / defended metrics (counterpart of the JAX
package's ``research/adversarial_robustness.py``).

The attacks take the gradient of the inference forward's cross-entropy
with respect to the node features (``torch.autograd.grad``; no parameter
gets a ``.grad``): on the card that backward runs the gather backward
kernels (``gather_rows_bwd``, ``gather_agg_bwd``) over the transposed
neighbor lists. Random draws (PGD's random start, the defense's noise) come
from a ``torch.Generator`` on the graph's device."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.graph import PaddedGraph, gather_neighbors, masked_neighbor_mean
from ..utils.logging import get_logger

__all__ = ["ClinicalAdversarialDefense", "MedicalAdversarialAttack", "RobustnessAnalyzer"]

logger = get_logger("research")


def bind_weights(model: torch.nn.Module, params: Optional[Mapping[str, torch.Tensor]]):
    """``model`` in eval mode, with ``params`` (a state dict, the JAX-style
    second argument) loaded strictly where given."""
    if params is not None:
        from ..convert import load_state

        load_state(model, params)
    return model.eval()


def feature_grad(loss_of, x: torch.Tensor) -> torch.Tensor:
    """∂ loss_of(x) / ∂x, x's dtype; gradients reach no parameter's ``.grad``."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_of(x), x)
    return g


class MedicalAdversarialAttack:
    """Feature-space attacks against a DGDM model: FGSM and L∞ PGD on the
    real nodes' features (padding rows are left as they are)."""

    def __init__(self, model, params=None, epsilon: float = 0.05, pgd_steps: int = 10,
                 pgd_alpha: Optional[float] = None):
        self.model = bind_weights(model, params)
        self.epsilon = epsilon
        self.pgd_steps = pgd_steps
        self.pgd_alpha = pgd_alpha or (2.5 * epsilon / pgd_steps)

    def loss_fn(self, graph: PaddedGraph, labels: torch.Tensor):
        """x -> the mean cross-entropy of the inference forward on ``graph``
        with features x (f32 logits)."""
        def loss_of(x):
            out = self.model(graph.replace(x=x), mode="inference", deterministic=True)
            logits = out["classification_logits"].float()
            onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
            return -(onehot * torch.log_softmax(logits, -1)).sum(-1).mean()
        return loss_of

    def fgsm(self, graph: PaddedGraph, labels: torch.Tensor) -> PaddedGraph:
        """Fast gradient sign attack: x + ε · sign(∂loss/∂x) on real nodes."""
        g = feature_grad(self.loss_fn(graph, labels), graph.x)
        x_adv = graph.x + self.epsilon * torch.sign(g)
        return graph.replace(x=torch.where(graph.node_mask[..., None], x_adv, graph.x))

    def pgd(self, graph: PaddedGraph, labels: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> PaddedGraph:
        """Projected gradient ascent in the L∞ ball of radius ε: ``pgd_steps``
        steps of α · sign(g), each clipped back into the ball; with a
        ``generator``, from a start drawn uniformly in the ball."""
        loss_of = self.loss_fn(graph, labels)
        x0 = graph.x
        x = x0
        if generator is not None:
            u = torch.rand(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
            x = x0 + (u * (2 * self.epsilon) - self.epsilon)
        lo, hi = x0 - self.epsilon, x0 + self.epsilon
        for _ in range(self.pgd_steps):
            x = x + self.pgd_alpha * torch.sign(feature_grad(loss_of, x))
            x = torch.minimum(torch.maximum(x, lo), hi)
        return graph.replace(x=torch.where(graph.node_mask[..., None], x, x0))

    def attack(self, graph: PaddedGraph, labels, method: str = "pgd",
               generator: Optional[torch.Generator] = None) -> PaddedGraph:
        labels = torch.as_tensor(labels, device=graph.x.device)
        if method == "fgsm":
            return self.fgsm(graph, labels)
        if method == "pgd":
            return self.pgd(graph, labels, generator)
        raise ValueError(f"unknown attack {method!r}")


class ClinicalAdversarialDefense:
    """Input defenses: smoothing each node toward the mean of its valid
    neighbors, per-node quantization to ``quantization_levels``, and gaussian
    noise (drawn from a generator). Padding rows are left as they are."""

    def __init__(self, smoothing_weight: float = 0.5, quantization_levels: int = 0,
                 noise_sigma: float = 0.0):
        self.smoothing_weight = smoothing_weight
        self.quantization_levels = quantization_levels
        self.noise_sigma = noise_sigma

    def defend(self, graph: PaddedGraph,
               generator: Optional[torch.Generator] = None) -> PaddedGraph:
        x = graph.x
        if self.smoothing_weight > 0:
            smooth = masked_neighbor_mean(gather_neighbors(x, graph.nbr_idx), graph.nbr_mask)
            has_nbr = graph.nbr_mask.any(-1, keepdim=True)
            w = self.smoothing_weight * has_nbr.to(x.dtype)
            x = (1 - w) * x + w * smooth
        if self.quantization_levels > 1:
            lo = x.amin(-1, keepdim=True)
            hi = x.amax(-1, keepdim=True)
            span = (hi - lo).clamp_min(1e-6)
            q = torch.round((x - lo) / span * (self.quantization_levels - 1))
            x = lo + q / (self.quantization_levels - 1) * span
        if self.noise_sigma > 0 and generator is not None:
            x = x + self.noise_sigma * torch.randn(x.shape, generator=generator,
                                                   device=x.device, dtype=x.dtype)
        return graph.replace(x=torch.where(graph.node_mask[..., None], x, graph.x))


class RobustnessAnalyzer:
    """Accuracy and confidence, clean against attacked (and defended)."""

    def __init__(self, model, params=None):
        self.model = bind_weights(model, params)

    def _predict(self, graph: PaddedGraph) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            out = self.model(graph, mode="inference", deterministic=True)
        logits = out["classification_logits"].float().cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        return {"pred": probs.argmax(-1), "conf": probs.max(-1)}

    def analyze(self, graph: PaddedGraph, labels, attack: MedicalAdversarialAttack,
                defense: Optional[ClinicalAdversarialDefense] = None,
                methods=("fgsm", "pgd"),
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``generator`` (seed 0 on the graph's device where None) draws
        PGD's start and the defense's noise, in the order of ``methods``."""
        labels_np = np.asarray(labels)
        clean = self._predict(graph)
        report: Dict[str, Any] = {
            "clean_accuracy": float((clean["pred"] == labels_np).mean()),
            "clean_confidence": float(clean["conf"].mean()),
            "attacks": {},
        }
        if generator is None:
            generator = torch.Generator(graph.x.device).manual_seed(0)
        for method in methods:
            adv = attack.attack(graph, labels, method=method, generator=generator)
            attacked = self._predict(adv)
            entry = {
                "accuracy": float((attacked["pred"] == labels_np).mean()),
                "confidence": float(attacked["conf"].mean()),
                "flip_rate": float((attacked["pred"] != clean["pred"]).mean()),
            }
            if defense is not None:
                defended = self._predict(defense.defend(adv, generator))
                entry["defended_accuracy"] = float((defended["pred"] == labels_np).mean())
            report["attacks"][method] = entry
        return report
