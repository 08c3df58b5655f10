"""Model comparison with statistical significance testing (host numpy; the
counterpart of the JAX package's ``research/comparative_studies.py``):
``BenchmarkSuite`` runs models over datasets and collects metrics,
``ModelComparator`` compares them pairwise, ``StatisticalValidator`` runs
the tests and effect sizes (paired t-test and Wilcoxon signed-rank with
normal approximations, bootstrap deltas, Cohen's d; no scipy needed).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("research")


@dataclass
class BenchmarkResult:
    model_name: str
    dataset_name: str
    metrics: Dict[str, float]
    per_sample_scores: Optional[np.ndarray] = None
    duration_s: float = 0.0


class BenchmarkSuite:
    """Run registered models over registered datasets, collect metric tables."""

    def __init__(self):
        self.models: Dict[str, Callable] = {}
        self.datasets: Dict[str, Any] = {}
        self.results: List[BenchmarkResult] = []

    def register_model(self, name: str, predict_fn: Callable) -> None:
        """predict_fn(dataset) -> dict with 'metrics' and optional
        'per_sample_scores'."""
        self.models[name] = predict_fn

    def register_dataset(self, name: str, dataset: Any) -> None:
        self.datasets[name] = dataset

    def run(self) -> List[BenchmarkResult]:
        self.results = []
        for mname, fn in self.models.items():
            for dname, ds in self.datasets.items():
                t0 = time.perf_counter()
                try:
                    out = fn(ds)
                except Exception as exc:  # noqa: BLE001
                    logger.error("benchmark %s/%s failed: %s", mname, dname, exc)
                    continue
                self.results.append(BenchmarkResult(
                    model_name=mname, dataset_name=dname,
                    metrics=dict(out.get("metrics", {})),
                    per_sample_scores=out.get("per_sample_scores"),
                    duration_s=time.perf_counter() - t0))
        return self.results

    def table(self, metric: str) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.results:
            out.setdefault(r.model_name, {})[r.dataset_name] = r.metrics.get(
                metric, float("nan"))
        return out


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _normal_sf(z: float) -> float:
    """Survival function of the standard normal."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def paired_t_test(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Two-sided paired t-test with a normal-approximation p-value (exact for
    large n)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    n = len(d)
    if n < 2:
        return {"t": float("nan"), "p": float("nan"), "mean_diff": float(d.mean()) if n else 0.0}
    sd = d.std(ddof=1)
    if sd == 0:
        return {"t": float("inf") if d.mean() != 0 else 0.0,
                "p": 0.0 if d.mean() != 0 else 1.0, "mean_diff": float(d.mean())}
    t = d.mean() / (sd / math.sqrt(n))
    p = 2.0 * _normal_sf(abs(t))
    return {"t": float(t), "p": float(min(1.0, p)), "mean_diff": float(d.mean())}


def wilcoxon_signed_rank(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Wilcoxon signed-rank with normal approximation."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d = d[d != 0]
    n = len(d)
    if n < 3:
        return {"w": float("nan"), "p": float("nan")}
    ranks = np.argsort(np.argsort(np.abs(d))) + 1.0
    w_pos = ranks[d > 0].sum()
    mu = n * (n + 1) / 4.0
    sigma = math.sqrt(n * (n + 1) * (2 * n + 1) / 24.0)
    z = (w_pos - mu) / sigma
    return {"w": float(w_pos), "p": float(min(1.0, 2.0 * _normal_sf(abs(z))))}


def cohens_d(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    pooled = math.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2.0)
    if pooled == 0:
        return 0.0
    return float((a.mean() - b.mean()) / pooled)


def bootstrap_diff_ci(a: np.ndarray, b: np.ndarray, n_bootstrap: int = 2000,
                      alpha: float = 0.05, seed: int = 0) -> Dict[str, float]:
    rs = np.random.RandomState(seed)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = len(a)
    diffs = [float(np.mean(a[idx]) - np.mean(b[idx]))
             for idx in (rs.randint(0, n, n) for _ in range(n_bootstrap))]
    lo, hi = np.percentile(diffs, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {"mean_diff": float(a.mean() - b.mean()),
            "lower": float(lo), "upper": float(hi),
            "significant": bool(lo > 0 or hi < 0)}


class StatisticalValidator:
    """Full significance battery over paired per-sample scores."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha

    def compare(self, scores_a: np.ndarray, scores_b: np.ndarray,
                name_a: str = "A", name_b: str = "B") -> Dict[str, Any]:
        t = paired_t_test(scores_a, scores_b)
        w = wilcoxon_signed_rank(scores_a, scores_b)
        ci = bootstrap_diff_ci(scores_a, scores_b)
        return {
            "models": (name_a, name_b),
            "mean": {name_a: float(np.mean(scores_a)),
                     name_b: float(np.mean(scores_b))},
            "paired_t": t,
            "wilcoxon": w,
            "bootstrap": ci,
            "effect_size_d": cohens_d(scores_a, scores_b),
            "significant": bool((not math.isnan(t["p"]) and t["p"] < self.alpha)
                                or ci["significant"]),
        }


class ModelComparator:
    """Pairwise comparison matrix over benchmark per-sample scores."""

    def __init__(self, alpha: float = 0.05):
        self.validator = StatisticalValidator(alpha)

    def compare_all(self, per_model_scores: Dict[str, np.ndarray]
                    ) -> Dict[str, Any]:
        names = sorted(per_model_scores)
        pairs = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                pairs[f"{a}_vs_{b}"] = self.validator.compare(
                    per_model_scores[a], per_model_scores[b], a, b)
        ranking = sorted(names,
                         key=lambda n: -float(np.mean(per_model_scores[n])))
        return {"ranking": ranking, "pairwise": pairs}
