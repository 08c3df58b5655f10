"""Experiment orchestration, results analysis and publication prep (host
only; the counterpart of the JAX package's ``research/experiment_framework.py``):
``ExperimentRunner`` runs an experiment function over seeds and appends one
JSON line a run to ``runs.jsonl``, ``ResultsAnalyzer`` aggregates runs,
``PublicationPreparer`` writes result tables and a reproducibility block.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("research")


@dataclass
class ExperimentConfig:
    name: str
    params: Dict[str, Any] = field(default_factory=dict)
    seeds: Sequence[int] = (0,)
    tags: Sequence[str] = ()


@dataclass
class RunRecord:
    experiment: str
    seed: int
    params: Dict[str, Any]
    metrics: Dict[str, float]
    duration_s: float
    status: str = "completed"
    error: Optional[str] = None


class ExperimentRunner:
    """Run experiment functions over seeds, persisting records as JSONL."""

    def __init__(self, output_dir: str | Path = "./experiments"):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.records: List[RunRecord] = []

    def run(self, config: ExperimentConfig,
            experiment_fn: Callable[[Dict[str, Any], int], Dict[str, float]]
            ) -> List[RunRecord]:
        """experiment_fn(params, seed) -> metric dict."""
        out = []
        for seed in config.seeds:
            t0 = time.perf_counter()
            try:
                metrics = experiment_fn(dict(config.params), seed)
                rec = RunRecord(config.name, seed, dict(config.params),
                                {k: float(v) for k, v in metrics.items()},
                                time.perf_counter() - t0)
            except Exception as exc:  # noqa: BLE001
                logger.error("experiment %s seed %d failed: %s",
                             config.name, seed, exc)
                rec = RunRecord(config.name, seed, dict(config.params), {},
                                time.perf_counter() - t0, status="failed",
                                error=str(exc))
            out.append(rec)
            self.records.append(rec)
            self._append_jsonl(rec)
        return out

    def run_grid(self, name: str, grid: Dict[str, Sequence[Any]],
                 experiment_fn, seeds: Sequence[int] = (0,)) -> List[RunRecord]:
        """Cartesian product sweep."""
        import itertools
        keys = sorted(grid)
        out = []
        for combo in itertools.product(*(grid[k] for k in keys)):
            params = dict(zip(keys, combo))
            cfg = ExperimentConfig(name=f"{name}:" + ",".join(
                f"{k}={v}" for k, v in params.items()), params=params, seeds=seeds)
            out.extend(self.run(cfg, experiment_fn))
        return out

    def _append_jsonl(self, rec: RunRecord) -> None:
        path = self.output_dir / "runs.jsonl"
        with open(path, "a") as f:
            f.write(json.dumps({
                "experiment": rec.experiment, "seed": rec.seed,
                "params": rec.params, "metrics": rec.metrics,
                "duration_s": rec.duration_s, "status": rec.status,
                "error": rec.error}) + "\n")

    @classmethod
    def load(cls, output_dir: str | Path) -> "ExperimentRunner":
        runner = cls(output_dir)
        path = runner.output_dir / "runs.jsonl"
        if path.exists():
            for line in path.read_text().splitlines():
                d = json.loads(line)
                runner.records.append(RunRecord(
                    d["experiment"], d["seed"], d["params"], d["metrics"],
                    d["duration_s"], d["status"], d.get("error")))
        return runner


class ResultsAnalyzer:
    """Aggregate runs: mean±std per experiment/metric, best configs."""

    def __init__(self, records: Sequence[RunRecord]):
        self.records = [r for r in records if r.status == "completed"]

    def aggregate(self, metric: str) -> Dict[str, Dict[str, float]]:
        groups: Dict[str, List[float]] = {}
        for r in self.records:
            if metric in r.metrics:
                groups.setdefault(r.experiment, []).append(r.metrics[metric])
        return {name: {"mean": float(np.mean(vals)), "std": float(np.std(vals)),
                       "n": len(vals), "min": float(np.min(vals)),
                       "max": float(np.max(vals))}
                for name, vals in groups.items()}

    def best(self, metric: str, mode: str = "max") -> Optional[RunRecord]:
        scored = [r for r in self.records if metric in r.metrics]
        if not scored:
            return None
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def seed_variance_report(self, metric: str) -> Dict[str, float]:
        agg = self.aggregate(metric)
        stds = [v["std"] for v in agg.values() if v["n"] > 1]
        return {"mean_seed_std": float(np.mean(stds)) if stds else 0.0,
                "max_seed_std": float(np.max(stds)) if stds else 0.0}


class PublicationPreparer:
    """Markdown result tables + reproducibility block."""

    def __init__(self, analyzer: ResultsAnalyzer):
        self.analyzer = analyzer

    def results_table(self, metrics: Sequence[str]) -> str:
        lines = ["| Experiment | " + " | ".join(metrics) + " |",
                 "|---" * (len(metrics) + 1) + "|"]
        names = sorted({r.experiment for r in self.analyzer.records})
        aggs = {m: self.analyzer.aggregate(m) for m in metrics}
        for name in names:
            cells = []
            for m in metrics:
                a = aggs[m].get(name)
                cells.append(f"{a['mean']:.4f} ± {a['std']:.4f}" if a else "—")
            lines.append(f"| {name} | " + " | ".join(cells) + " |")
        return "\n".join(lines)

    def reproducibility_block(self) -> str:
        import torch
        seeds = sorted({r.seed for r in self.analyzer.records})
        device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        return "\n".join([
            "## Reproducibility",
            f"- torch {torch.__version__}, CUDA {torch.version.cuda}, device {device}",
            f"- seeds: {seeds}",
            f"- runs: {len(self.analyzer.records)}",
        ])

    def export(self, path: str | Path, metrics: Sequence[str]) -> Path:
        path = Path(path)
        path.write_text(self.results_table(metrics) + "\n\n"
                        + self.reproducibility_block() + "\n")
        return path
