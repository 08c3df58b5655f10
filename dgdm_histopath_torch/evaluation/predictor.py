"""DGDMPredictor, graph-level surface: checkpoint -> prediction dicts.

Counterpart of the JAX package's ``evaluation/predictor.py``
``predict_graph``, ``predict_batch``, ``rank_biomarkers``,
``compute_uncertainty`` and ``get_model_info``. The slide-level methods
wait for the preprocessing and featurizer slices.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import load_jax_bundle
from ..models.dgdm import DGDMModel
from ..ops.graph import PaddedGraph, batch_graphs
from ..utils.device import resolve_device
from ..utils.exceptions import CheckpointError, InferenceError


def load_model_checkpoint(path, device=None):
    """Load a JAX ``save_model_bundle`` npz -> (DGDMModel on ``device``, meta).
    ``device=None`` means ``"cuda"``."""
    path = Path(path)
    if not path.exists():
        raise InferenceError("checkpoint not found", {"path": str(path)})
    dev = resolve_device(device)
    try:
        model, _, meta = load_jax_bundle(path)
    except CheckpointError as exc:
        raise InferenceError("checkpoint/model structure mismatch",
                             {"path": str(path), "error": str(exc)}) from exc
    return model.to(dev).eval(), meta


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class DGDMPredictor:
    """Graph-level inference on ``device`` (``None`` means ``"cuda"``; raises
    when no card is present, never falls back to the CPU)."""

    def __init__(self, model_path: Optional[str | Path] = None,
                 model: Optional[DGDMModel] = None, device=None,
                 quant: Optional[str] = None):
        if quant == "int8":
            raise NotImplementedError("int8 inference is not ported yet "
                                      "(ROADMAP queue 1, item 13)")
        if quant is not None:
            raise InferenceError(f"unsupported quant mode: {quant!r}")
        self.quant = quant
        self.device = resolve_device(device)
        if model_path is not None:
            self.model, self.checkpoint_meta = load_model_checkpoint(model_path, self.device)
        elif model is not None:
            self.model, self.checkpoint_meta = model.to(self.device).eval(), {}
        else:
            raise InferenceError("provide model_path or model")

    def forward(self, batch: PaddedGraph) -> Dict[str, Any]:
        """The model's inference forward with attention, on the predictor's device."""
        with torch.inference_mode():
            return self.model(batch.to(self.device), mode="inference",
                              deterministic=True, return_attention=True)

    def predict_graph(self, graph: PaddedGraph) -> Dict[str, Any]:
        """Model forward on a single graph."""
        batched = graph if graph.x.dim() == 3 else graph.unsqueeze()
        out = self.forward(batched)
        result: Dict[str, Any] = {"graph_embedding": _host(out["graph_embedding"])[0]}
        if "classification_logits" in out:
            logits = _host(out["classification_logits"])[0]
            probs = np.exp(logits - logits.max())
            probs = probs / probs.sum()
            result.update({
                "logits": logits,
                "probabilities": probs,
                "predicted_class": int(probs.argmax()),
                "confidence": float(probs.max()),
                "uncertainty": self.compute_uncertainty(probs),
            })
        if "regression" in out:
            result["regression"] = _host(out["regression"]["mean"])[0]
        if "survival" in out:
            result["survival"] = {k: _host(v)[0] for k, v in out["survival"].items()}
        if "attention_weights" in out:
            attn = _host(out["attention_weights"])[0]
            result["attention_weights"] = attn
            result["biomarkers"] = self.rank_biomarkers(
                attn, batched.node_mask[0].cpu().numpy(), _host(batched.pos)[0])
        return result

    def predict_batch(self, graphs: Sequence[PaddedGraph]) -> List[Dict[str, Any]]:
        """Same-bucket graphs are stacked and run in one forward each."""
        results: List[Optional[Dict[str, Any]]] = [None] * len(graphs)
        by_shape: Dict[tuple, List[int]] = {}
        for i, g in enumerate(graphs):
            by_shape.setdefault((g.num_nodes, g.max_neighbors, g.feature_dim), []).append(i)
        for idxs in by_shape.values():
            out = self.forward(batch_graphs([graphs[i] for i in idxs]))
            emb = _host(out["graph_embedding"])
            logits = (_host(out["classification_logits"])
                      if "classification_logits" in out else None)
            attn = _host(out["attention_weights"]) if "attention_weights" in out else None
            for row, i in enumerate(idxs):
                r: Dict[str, Any] = {"graph_embedding": emb[row]}
                if logits is not None:
                    probs = np.exp(logits[row] - logits[row].max())
                    probs /= probs.sum()
                    r.update({"probabilities": probs,
                              "predicted_class": int(probs.argmax()),
                              "confidence": float(probs.max()),
                              "uncertainty": self.compute_uncertainty(probs)})
                if attn is not None:
                    r["attention_weights"] = attn[row]
                results[i] = r
        return results  # type: ignore[return-value]

    @staticmethod
    def rank_biomarkers(attention: np.ndarray, node_mask: np.ndarray,
                        pos: np.ndarray, top_k: int = 10) -> List[Dict[str, Any]]:
        """Rank patches by pooled attention."""
        attn = np.where(node_mask, attention, -np.inf)
        order = np.argsort(-attn)[:top_k]
        out = []
        for rank, i in enumerate(order):
            if not node_mask[i]:
                break
            out.append({
                "rank": rank + 1,
                "node_index": int(i),
                "attention_score": float(attention[i]),
                "position": [float(pos[i, 0]), float(pos[i, 1])],
            })
        return out

    @staticmethod
    def compute_uncertainty(probs: np.ndarray) -> Dict[str, float]:
        """entropy / max-prob / margin."""
        p = np.clip(np.asarray(probs, np.float64), 1e-12, 1.0)
        entropy = float(-(p * np.log(p)).sum())
        top2 = np.sort(p)[-2:]
        return {
            "entropy": entropy,
            "normalized_entropy": entropy / np.log(len(p)) if len(p) > 1 else 0.0,
            "max_probability": float(p.max()),
            "margin": float(top2[1] - top2[0]) if len(p) > 1 else 1.0,
        }

    def get_model_info(self) -> Dict[str, Any]:
        m = self.model
        return {
            "model_type": "DGDMModel",
            "num_parameters": sum(p.numel() for p in m.parameters()),
            "node_features": m.node_features,
            "hidden_dims": list(m.hidden_dims),
            "num_classes": m.num_classes,
            "pooling": m.pooling,
            "compute_dtype": m.compute_dtype,
            "device": str(self.device),
            "checkpoint_meta": {k: v for k, v in self.checkpoint_meta.items()
                                if k != "treedef"},
        }
