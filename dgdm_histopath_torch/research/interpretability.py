"""Clinical interpretability: gradient saliency over tissue-graph nodes,
region summaries and report text (counterpart of the JAX package's
``research/interpretability.py``).

The saliency is the gradient of a class logit of the inference forward with
respect to the node features (``torch.autograd.grad``; no parameter gets a
``.grad``): on the card its backward runs the gather backward kernels over
the transposed neighbor lists, 9 ``gather_rows_bwd``, 18 ``gather_agg_bwd``
and 3 list builds for DGDM-Base, as one training step does."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.graph import PaddedGraph
from ..utils.logging import get_logger
from .adversarial_robustness import bind_weights, feature_grad

__all__ = ["ClinicalReportGenerator", "ClinicalSaliencyAnalyzer", "PathologyFeatureExtractor"]

logger = get_logger("research")


class ClinicalSaliencyAnalyzer:
    """Gradient-based saliency over tissue-graph nodes."""

    def __init__(self, model, params=None):
        self.model = bind_weights(model, params)

    def class_score_grad(self, x: torch.Tensor, graph: PaddedGraph,
                         class_idx: int) -> torch.Tensor:
        """∂ Σ_b logits[b, class_idx] / ∂x of the inference forward on
        ``graph`` with features x."""
        def score(x):
            out = self.model(graph.replace(x=x), mode="inference", deterministic=True)
            return out["classification_logits"][..., class_idx].sum()
        return feature_grad(score, x)

    def node_saliency(self, graph: PaddedGraph, class_idx: Optional[int] = None) -> np.ndarray:
        """The L2 norm of each node's gradient -> [B, N], zero on padding;
        ``class_idx`` defaults to the first graph's predicted class."""
        if class_idx is None:
            with torch.no_grad():
                out = self.model(graph, mode="inference", deterministic=True)
            class_idx = int(out["classification_logits"].argmax(-1).reshape(-1)[0])
        g = self.class_score_grad(graph.x, graph, class_idx)
        sal = torch.sqrt((g.float() ** 2).sum(-1)).cpu().numpy()
        return sal * graph.node_mask.cpu().numpy()

    def integrated_gradients(self, graph: PaddedGraph, class_idx: int,
                             steps: int = 16) -> np.ndarray:
        """Integrated gradients from the zero-feature baseline: the mean of
        the gradients at ``steps`` points α ∈ linspace(0, 1) of the path α·x,
        times x, summed over features -> [B, N], zero on padding."""
        alphas = torch.linspace(0.0, 1.0, steps)
        grads = torch.stack([self.class_score_grad(graph.x * float(a), graph, class_idx)
                             for a in alphas])
        ig = (graph.x * grads.mean(0)).sum(-1).float().cpu().numpy()
        return ig * graph.node_mask.cpu().numpy()


class PathologyFeatureExtractor:
    """Region-level morphology summaries from saliency and coordinates."""

    @staticmethod
    def summarize_regions(saliency: np.ndarray, pos: np.ndarray, node_mask: np.ndarray,
                          top_fraction: float = 0.1) -> Dict[str, Any]:
        sal = saliency[node_mask]
        coords = pos[node_mask]
        if len(sal) == 0:
            return {"num_nodes": 0}
        k = max(1, int(len(sal) * top_fraction))
        top_coords = coords[np.argsort(-sal)[:k]]
        centroid = top_coords.mean(axis=0)
        spread = top_coords.std(axis=0)
        return {
            "num_nodes": int(len(sal)),
            "salient_nodes": int(k),
            "saliency_mean": float(sal.mean()),
            "saliency_max": float(sal.max()),
            "salient_centroid": [float(centroid[0]), float(centroid[1])],
            "salient_spread": [float(spread[0]), float(spread[1])],
            "focality": float(1.0 / (1.0 + spread.mean())),  # 1 focal, -> 0 diffuse
        }


class ClinicalReportGenerator:
    """Structured findings -> a narrative summary in one of the languages of
    ``utils.globalization``."""

    def __init__(self, class_names: Optional[List[str]] = None, language: str = "en"):
        from ..utils.globalization import InternationalizationManager

        self.class_names = class_names
        self.i18n = InternationalizationManager(language)

    def generate(self, prediction: Dict[str, Any],
                 region_summary: Optional[Dict[str, Any]] = None) -> str:
        lines = []
        cls = prediction.get("predicted_class")
        name = (self.class_names[cls] if self.class_names and cls is not None
                else f"class {cls}")
        conf = prediction.get("confidence", 0.0)
        lines.append(f"{self.i18n.t('prediction')}: {name} "
                     f"({self.i18n.t('confidence').lower()}: {conf:.1%}).")
        unc = prediction.get("uncertainty", {})
        if unc:
            ent = unc.get("normalized_entropy", 0)
            level = "low" if ent < 0.3 else "moderate" if ent < 0.7 else "high"
            lines.append(f"Model {self.i18n.t('uncertainty').lower()} is {level} "
                         f"(normalized entropy {ent:.2f}).")
        if region_summary and region_summary.get("num_nodes"):
            pattern = "focal" if region_summary["focality"] > 0.6 else "multifocal/diffuse"
            cx, cy = region_summary["salient_centroid"]
            lines.append(
                f"Attention is {pattern}; the most informative region is "
                f"centered at normalized coordinates ({cx:.2f}, {cy:.2f}) "
                f"covering {region_summary['salient_nodes']} of "
                f"{region_summary['num_nodes']} analyzed tissue patches.")
        bios = prediction.get("biomarkers") or []
        if bios:
            top = bios[0]
            lines.append(f"Top-ranked region (attention "
                         f"{top['attention_score']:.3f}) at position "
                         f"({top['position'][0]:.2f}, {top['position'][1]:.2f}).")
        lines.append("This is a research-use-only computational analysis and "
                     "not a clinical diagnosis.")
        return " ".join(lines)
