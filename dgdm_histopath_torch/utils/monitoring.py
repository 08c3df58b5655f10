"""Operation timing (the part of the JAX package's ``utils/monitoring.py``
that training uses): ``monitor_operation`` times a block, records its RSS
delta in a ``MetricsCollector`` and opens a ``torch.profiler`` span of the
same name, so the block shows in a profiler trace of the card."""

from __future__ import annotations

import contextlib
import resource
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from .logging import get_logger

logger = get_logger("monitoring")


def _rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@dataclass
class PerformanceMetrics:
    operation: str
    duration_s: float
    rss_delta_bytes: int = 0
    timestamp: float = field(default_factory=time.time)
    extra: Dict[str, Any] = field(default_factory=dict)


class MetricsCollector:
    """Thread-safe rolling store of operation metrics."""

    def __init__(self, max_records_per_op: int = 1000):
        self._lock = threading.Lock()
        self._records: Dict[str, deque] = defaultdict(lambda: deque(maxlen=max_records_per_op))
        self._counters: Dict[str, float] = defaultdict(float)

    def record(self, metrics: PerformanceMetrics) -> None:
        with self._lock:
            self._records[metrics.operation].append(metrics)

    def increment(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def summary(self, operation: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            ops = [operation] if operation else list(self._records)
            out: Dict[str, Any] = {}
            for op in ops:
                recs = list(self._records.get(op, ()))
                if not recs:
                    continue
                durations = [r.duration_s for r in recs]
                out[op] = {"count": len(recs), "total_s": sum(durations),
                           "mean_s": sum(durations) / len(recs), "max_s": max(durations),
                           "min_s": min(durations), "last_s": durations[-1]}
            return out

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._counters.clear()


GLOBAL_METRICS = MetricsCollector()


@contextlib.contextmanager
def monitor_operation(name: str, collector: Optional[MetricsCollector] = None,
                      trace: bool = True, log_level: Optional[int] = None, **extra: Any):
    """Time an operation, record its RSS delta, and (``trace``) open a
    profiler span of the same name."""
    collector = collector or GLOBAL_METRICS
    span = torch.profiler.record_function(name) if trace else contextlib.nullcontext()
    rss0 = _rss_bytes()
    start = time.perf_counter()
    try:
        with span:
            yield
    finally:
        duration = time.perf_counter() - start
        collector.record(PerformanceMetrics(operation=name, duration_s=duration,
                                            rss_delta_bytes=_rss_bytes() - rss0,
                                            extra=dict(extra)))
        if log_level is not None:
            logger.log(log_level, "%s: %.4fs", name, duration)
