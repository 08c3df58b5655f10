"""AttentionVisualizer: heatmaps, graph renders, prediction summaries
(counterpart of the JAX package's ``evaluation/visualizer.py``).

Static figures are matplotlib under the ``Agg`` backend, imported at first
use (``ImportError`` where matplotlib is missing). Interactive figures are
plain plotly-schema dicts (``{"data": [...], "layout": {...}}``): they need no
plotly, write to standalone HTML (plotly.js from its CDN) or JSON with
:func:`save_interactive`, and become ``plotly.graph_objects.Figure`` through
:func:`to_plotly_figure` where plotly is importable.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

MATPLOTLIB_AVAILABLE = importlib.util.find_spec("matplotlib") is not None
PLOTLY_AVAILABLE = importlib.util.find_spec("plotly") is not None


def _pyplot():
    """matplotlib.pyplot on the Agg backend."""
    if not MATPLOTLIB_AVAILABLE:
        raise ImportError("matplotlib is required for visualization")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<script src="https://cdn.plot.ly/plotly-2.27.0.min.js"></script>
</head><body>
<div id="fig" style="width:100%;height:92vh;"></div>
<script>
var spec = {spec_json};
Plotly.newPlot("fig", spec.data, spec.layout, {{responsive: true}});
</script>
</body></html>
"""


def save_interactive(spec: Dict[str, Any], save_path: str | Path) -> Path:
    """Write a plotly figure spec as standalone ``.html`` (plotly.js CDN) or
    raw ``.json``; no plotly import needed."""
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    if save_path.suffix == ".json":
        save_path.write_text(json.dumps(spec))
    else:
        save_path.write_text(
            _HTML_TEMPLATE.format(spec_json=json.dumps(spec)))
    return save_path


def to_plotly_figure(spec: Dict[str, Any]):
    """Wrap a figure spec in ``plotly.graph_objects.Figure`` (requires
    plotly)."""
    if not PLOTLY_AVAILABLE:
        raise ImportError("plotly is required for Figure objects; the dict "
                          "spec and save_interactive() work without it")
    import plotly.graph_objects as go
    return go.Figure(spec)


class AttentionVisualizer:
    """Render attention/uncertainty/biomarker figures for slide predictions."""

    def __init__(self, cmap: str = "viridis", figsize=(10, 8), dpi: int = 120):
        self.cmap = cmap
        self.figsize = figsize
        self.dpi = dpi

    # ------------------------------------------------------------------
    def attention_heatmap(
        self,
        pos: np.ndarray,                 # [N, 2] normalized coords
        attention: np.ndarray,           # [N]
        node_mask: Optional[np.ndarray] = None,
        save_path: Optional[str | Path] = None,
        title: str = "Attention heatmap",
    ):
        """Scatter heatmap of per-patch attention."""
        plt = _pyplot()
        if node_mask is not None:
            pos, attention = pos[node_mask], attention[node_mask]
        fig, ax = plt.subplots(figsize=self.figsize, dpi=self.dpi)
        sc = ax.scatter(pos[:, 0], 1.0 - pos[:, 1], c=attention,
                        cmap=self.cmap, s=24, edgecolors="none")
        fig.colorbar(sc, ax=ax, label="attention")
        ax.set_title(title)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_aspect("equal")
        return self._finish(fig, save_path)

    def render_graph(
        self,
        pos: np.ndarray,
        nbr_idx: np.ndarray,
        nbr_mask: np.ndarray,
        node_mask: Optional[np.ndarray] = None,
        node_values: Optional[np.ndarray] = None,
        save_path: Optional[str | Path] = None,
        max_edges: int = 2000,
        title: str = "Tissue graph",
    ):
        """Node-link render of the tissue graph."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=self.figsize, dpi=self.dpi)
        n = pos.shape[0]
        mask = node_mask if node_mask is not None else np.ones(n, bool)
        # edges
        src = nbr_idx.reshape(-1)
        dst = np.repeat(np.arange(n), nbr_idx.shape[1])
        ok = nbr_mask.reshape(-1) & mask[dst] & mask[src]
        src, dst = src[ok][:max_edges], dst[ok][:max_edges]
        for s, d in zip(src, dst):
            ax.plot([pos[s, 0], pos[d, 0]], [1 - pos[s, 1], 1 - pos[d, 1]],
                    color="lightgray", linewidth=0.4, zorder=1)
        vals = node_values[mask] if node_values is not None else "tab:blue"
        sc = ax.scatter(pos[mask, 0], 1 - pos[mask, 1], c=vals, cmap=self.cmap,
                        s=22, zorder=2)
        if node_values is not None:
            fig.colorbar(sc, ax=ax)
        ax.set_title(title)
        ax.set_aspect("equal")
        return self._finish(fig, save_path)

    def prediction_summary(
        self,
        result: Dict[str, Any],
        class_names: Optional[Sequence[str]] = None,
        save_path: Optional[str | Path] = None,
    ):
        """Multi-panel summary: probabilities + attention + uncertainty."""
        plt = _pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5), dpi=self.dpi)
        # class probabilities
        probs = result.get("probabilities")
        if probs is not None:
            names = class_names or [f"class {i}" for i in range(len(probs))]
            axes[0].bar(range(len(probs)), probs, color="tab:blue")
            axes[0].set_xticks(range(len(probs)))
            axes[0].set_xticklabels(names, rotation=30, ha="right")
            axes[0].set_ylim(0, 1)
            axes[0].set_title(f"prediction: {names[result['predicted_class']]}"
                              f" ({result['confidence']:.2f})")
        # attention spatial map
        attn = result.get("attention_weights")
        infos = result.get("patch_info")
        if attn is not None and infos:
            xs = np.asarray([p["x"] for p in infos], np.float64)
            ys = np.asarray([p["y"] for p in infos], np.float64)
            xs = xs / max(xs.max(), 1)
            ys = ys / max(ys.max(), 1)
            sc = axes[1].scatter(xs, 1 - ys, c=attn[: len(xs)], cmap=self.cmap, s=14)
            fig.colorbar(sc, ax=axes[1])
            axes[1].set_title("patch attention")
            axes[1].set_aspect("equal")
        # uncertainty
        unc = result.get("uncertainty")
        if unc:
            keys = ["entropy", "normalized_entropy", "max_probability", "margin"]
            vals = [unc.get(k, np.nan) for k in keys]
            axes[2].bar(range(len(keys)), vals, color="tab:orange")
            axes[2].set_xticks(range(len(keys)))
            axes[2].set_xticklabels(keys, rotation=30, ha="right")
            axes[2].set_title("uncertainty")
        fig.suptitle(result.get("slide_id", ""))
        fig.tight_layout()
        return self._finish(fig, save_path)

    # ------------------------------------------------------------------
    # interactive (plotly-schema) variants
    # ------------------------------------------------------------------
    def attention_heatmap_interactive(
        self,
        pos: np.ndarray,
        attention: np.ndarray,
        node_mask: Optional[np.ndarray] = None,
        save_path: Optional[str | Path] = None,
        title: str = "Attention heatmap",
        as_figure: bool = False,
    ):
        """Interactive scatter heatmap with per-patch hover. Returns the figure spec
        dict (or a ``go.Figure`` with ``as_figure=True``); writes standalone
        HTML/JSON when ``save_path`` is given."""
        pos = np.asarray(pos, np.float64)
        attention = np.asarray(attention, np.float64)
        if node_mask is not None:
            mask = np.asarray(node_mask, bool)
            pos, attention = pos[mask], attention[mask]
        hover = [f"patch {i}<br>x={x:.3f} y={y:.3f}<br>attention={a:.4f}"
                 for i, ((x, y), a) in enumerate(zip(pos, attention))]
        spec = {
            "data": [{
                "type": "scattergl",
                "mode": "markers",
                "x": pos[:, 0].tolist(),
                "y": (1.0 - pos[:, 1]).tolist(),
                "text": hover,
                "hoverinfo": "text",
                "marker": {
                    "size": 7,
                    "color": attention.tolist(),
                    "colorscale": "Viridis",
                    "colorbar": {"title": "attention"},
                    "showscale": True,
                },
            }],
            "layout": {
                "title": {"text": title},
                "xaxis": {"range": [0, 1], "title": "x"},
                "yaxis": {"range": [0, 1], "title": "y",
                          "scaleanchor": "x", "scaleratio": 1},
                "template": "plotly_white",
            },
        }
        if save_path is not None:
            save_interactive(spec, save_path)
        return to_plotly_figure(spec) if as_figure else spec

    def prediction_summary_interactive(
        self,
        result: Dict[str, Any],
        class_names: Optional[Sequence[str]] = None,
        save_path: Optional[str | Path] = None,
        as_figure: bool = False,
    ):
        """Interactive multi-panel summary: class probabilities + spatial
        attention + uncertainty. Panels share one layout via axis domains."""
        data: List[Dict[str, Any]] = []
        layout: Dict[str, Any] = {
            "title": {"text": str(result.get("slide_id", "prediction"))},
            "template": "plotly_white",
            "showlegend": False,
            # three side-by-side panels
            "xaxis": {"domain": [0.0, 0.30]},
            "yaxis": {"range": [0, 1], "title": "probability"},
            "xaxis2": {"domain": [0.36, 0.66], "anchor": "y2", "title": "x"},
            "yaxis2": {"anchor": "x2", "title": "y"},
            "xaxis3": {"domain": [0.72, 1.0], "anchor": "y3"},
            "yaxis3": {"anchor": "x3", "title": "value"},
        }
        probs = result.get("probabilities")
        if probs is not None:
            probs = np.asarray(probs, np.float64)
            names = list(class_names or [f"class {i}" for i in range(len(probs))])
            data.append({
                "type": "bar", "x": names, "y": probs.tolist(),
                "marker": {"color": "#3366cc"},
                "xaxis": "x", "yaxis": "y",
                "hovertemplate": "%{x}: %{y:.3f}<extra></extra>",
            })
            pred = result.get("predicted_class")
            if pred is not None:
                conf = result.get("confidence", float(probs.max()))
                layout["annotations"] = [{
                    "x": 0.15, "y": 1.08, "xref": "paper", "yref": "paper",
                    "showarrow": False,
                    "text": f"prediction: {names[int(pred)]} ({conf:.2f})",
                }]
        attn = result.get("attention_weights")
        infos = result.get("patch_info")
        if attn is not None and infos:
            xs = np.asarray([p["x"] for p in infos], np.float64)
            ys = np.asarray([p["y"] for p in infos], np.float64)
            xs = xs / max(xs.max(), 1)
            ys = ys / max(ys.max(), 1)
            a = np.asarray(attn, np.float64)[: len(xs)]
            data.append({
                "type": "scattergl", "mode": "markers",
                "x": xs.tolist(), "y": (1 - ys).tolist(),
                "marker": {"size": 6, "color": a.tolist(),
                           "colorscale": "Viridis", "showscale": True,
                           "colorbar": {"title": "attention", "x": 0.66}},
                "xaxis": "x2", "yaxis": "y2",
                "hovertemplate": "attention=%{marker.color:.4f}<extra></extra>",
            })
        unc = result.get("uncertainty")
        if unc:
            keys = ["entropy", "normalized_entropy", "max_probability", "margin"]
            vals = [float(unc.get(k, np.nan)) for k in keys]
            data.append({
                "type": "bar", "x": keys, "y": vals,
                "marker": {"color": "#ff7f0e"},
                "xaxis": "x3", "yaxis": "y3",
                "hovertemplate": "%{x}: %{y:.3f}<extra></extra>",
            })
        spec = {"data": data, "layout": layout}
        if save_path is not None:
            save_interactive(spec, save_path)
        return to_plotly_figure(spec) if as_figure else spec

    def biomarker_chart(self, biomarkers: List[Dict[str, Any]],
                        save_path: Optional[str | Path] = None):
        """Top-k biomarker attention bar chart."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(8, 5), dpi=self.dpi)
        ranks = [b["rank"] for b in biomarkers]
        scores = [b["attention_score"] for b in biomarkers]
        ax.barh(ranks, scores, color="tab:green")
        ax.invert_yaxis()
        ax.set_xlabel("attention score")
        ax.set_ylabel("biomarker rank")
        ax.set_title("Top attended regions")
        return self._finish(fig, save_path)

    def uncertainty_plot(self, uncertainties: List[Dict[str, float]],
                         save_path: Optional[str | Path] = None):
        """Cohort-level uncertainty distribution."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(8, 5), dpi=self.dpi)
        ent = [u["entropy"] for u in uncertainties]
        ax.hist(ent, bins=20, color="tab:purple", alpha=0.8)
        ax.set_xlabel("prediction entropy")
        ax.set_ylabel("count")
        ax.set_title("Uncertainty distribution")
        return self._finish(fig, save_path)

    # ------------------------------------------------------------------
    def _finish(self, fig, save_path):
        plt = _pyplot()
        if save_path is not None:
            save_path = Path(save_path)
            save_path.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(save_path, bbox_inches="tight")
            plt.close(fig)
            return save_path
        return fig
