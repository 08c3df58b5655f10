"""Hyperparameter search: annealed random search over a typed space
(counterpart of the JAX package's ``quantum/optimizer.py``).

A population of configurations is drawn first; each later trial perturbs a
random incumbent by a step that shrinks over the run, and a better trial
replaces a random incumbent. The draws come from ``random.Random(seed)`` in
the JAX package's order, so the same seed and objective give the same
trials. ``dgdm_search_space`` is the space of DGDM training runs: an
objective that builds and trains a ``DGDMModel`` from each configuration
runs the gather kernels and their backwards.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.logging import get_logger

logger = get_logger("quantum")


@dataclass
class Parameter:
    name: str
    kind: str                      # float | int | log_float | choice
    low: Optional[float] = None
    high: Optional[float] = None
    choices: Optional[Sequence[Any]] = None

    def sample(self, rng: random.Random) -> Any:
        if self.kind == "choice":
            return rng.choice(list(self.choices))
        if self.kind == "int":
            return rng.randint(int(self.low), int(self.high))
        if self.kind == "log_float":
            return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        return rng.uniform(self.low, self.high)

    def perturb(self, value: Any, scale: float, rng: random.Random) -> Any:
        """A local move; ``scale`` in (0, 1] shrinks over the run."""
        if self.kind == "choice":
            return rng.choice(list(self.choices)) if rng.random() < scale else value
        if self.kind == "int":
            span = max(1, int((self.high - self.low) * scale * 0.5))
            return int(min(max(value + rng.randint(-span, span), self.low), self.high))
        if self.kind == "log_float":
            lo, hi = math.log(self.low), math.log(self.high)
            x = math.log(value) + rng.gauss(0, (hi - lo) * scale * 0.25)
            return math.exp(min(max(x, lo), hi))
        span = (self.high - self.low) * scale * 0.25
        return min(max(value + rng.gauss(0, span), self.low), self.high)


class OptimizationSpace:
    """Named, typed hyperparameters; each ``add_*`` returns the space."""

    def __init__(self):
        self.params: Dict[str, Parameter] = {}

    def add_float(self, name: str, low: float, high: float, log: bool = False):
        self.params[name] = Parameter(name, "log_float" if log else "float", low, high)
        return self

    def add_int(self, name: str, low: int, high: int):
        self.params[name] = Parameter(name, "int", low, high)
        return self

    def add_choice(self, name: str, choices: Sequence[Any]):
        self.params[name] = Parameter(name, "choice", choices=list(choices))
        return self

    def sample(self, rng: random.Random) -> Dict[str, Any]:
        return {n: p.sample(rng) for n, p in self.params.items()}

    def perturb(self, config: Dict[str, Any], scale: float,
                rng: random.Random) -> Dict[str, Any]:
        return {n: p.perturb(config[n], scale, rng) for n, p in self.params.items()}


@dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    value: float
    duration_s: float
    timestamp: float = field(default_factory=time.time)


class QuantumOptimizer:
    """Annealed population search minimizing (``mode="min"``) or maximizing
    ``objective(config)``; a trial whose objective raises scores the worst
    value and the search goes on."""

    def __init__(self, space: OptimizationSpace, objective: Callable[[Dict], float],
                 mode: str = "min", population: int = 4, seed: int = 0):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min|max")
        self.space = space
        self.objective = objective
        self.mode = mode
        self.population = population
        self.history: List[Trial] = []
        self._rng = random.Random(seed)

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def optimize(self, n_trials: int = 20,
                 early_stop_patience: Optional[int] = None) -> Tuple[Dict, float]:
        best_cfg: Optional[Dict] = None
        best_val = math.inf if self.mode == "min" else -math.inf
        stale = 0
        incumbents: List[Dict] = [self.space.sample(self._rng) for _ in range(self.population)]
        for t in range(n_trials):
            scale = max(0.05, 1.0 - t / max(n_trials - 1, 1))
            if t < self.population:
                cfg = incumbents[t]
            else:
                cfg = self.space.perturb(self._rng.choice(incumbents), scale, self._rng)
            t0 = time.perf_counter()
            try:
                val = float(self.objective(cfg))
            except Exception as exc:  # noqa: BLE001 - a failed trial scores the worst value
                logger.error("trial %d failed: %s", t, exc)
                val = math.inf if self.mode == "min" else -math.inf
            self.history.append(Trial(t, cfg, val, time.perf_counter() - t0))
            if self._better(val, best_val):
                best_val, best_cfg = val, cfg
                stale = 0
                incumbents[self._rng.randrange(len(incumbents))] = cfg
            else:
                stale += 1
            if early_stop_patience and stale >= early_stop_patience:
                logger.info("early stop after %d stale trials", stale)
                break
        return best_cfg, best_val

    @property
    def convergence(self) -> List[float]:
        """The best value so far after each trial."""
        out, best = [], (math.inf if self.mode == "min" else -math.inf)
        for t in self.history:
            if self._better(t.value, best):
                best = t.value
            out.append(best)
        return out


def dgdm_search_space() -> OptimizationSpace:
    """The DGDM training hyperparameters the reference searches."""
    return (OptimizationSpace()
            .add_float("learning_rate", 1e-5, 1e-3, log=True)
            .add_float("weight_decay", 1e-6, 1e-3, log=True)
            .add_float("dropout", 0.0, 0.3)
            .add_float("masking_ratio", 0.05, 0.3)
            .add_choice("hidden_dims", [(512, 256, 128), (256, 128), (768, 384, 192)])
            .add_int("num_diffusion_steps", 5, 20)
            .add_choice("pooling", ["attention", "mean", "set2set"])
            .add_float("contrastive_temperature", 0.05, 0.3))
