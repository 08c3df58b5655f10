"""Operation timing and health (counterpart of the JAX package's
``utils/monitoring.py``): ``monitor_operation`` times a block, records its RSS
delta in a ``MetricsCollector`` and opens a ``torch.profiler`` span of the
same name, so the block shows in a profiler trace of the card;
``device_memory_stats`` reads the CUDA allocator of each card;
``HealthChecker`` / ``GLOBAL_HEALTH`` run named checks (host memory, a
device to run on); ``profiler_trace`` writes a TensorBoard trace."""

from __future__ import annotations

import contextlib
import resource
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

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


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use, reserved and at peak per CUDA device (empty without one)."""
    stats: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        mem = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": int(mem.get("allocated_bytes.all.current", 0)),
            "bytes_reserved": int(mem.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            "peak_bytes_in_use": int(mem.get("allocated_bytes.all.peak", 0)),
        }
    return stats


@dataclass
class HealthCheck:
    name: str
    check: Callable[[], bool]
    description: str = ""


class HealthChecker:
    """Registry of named health checks with aggregated status reporting."""

    def __init__(self):
        self._checks: Dict[str, HealthCheck] = {}
        self.register("host_memory", self._host_memory_ok,
                      "more than 256 MiB of host memory available")
        self.register("devices", self._devices_ok,
                      "at least one device the port can run on is reachable")

    def register(self, name: str, check: Callable[[], bool], description: str = "") -> None:
        self._checks[name] = HealthCheck(name, check, description)

    @staticmethod
    def _host_memory_ok() -> bool:
        try:
            with open("/proc/meminfo") as f:
                info = {line.split(":")[0]: int(line.split()[1]) for line in f if ":" in line}
            return info.get("MemAvailable", 1) * 1024 > 256 * 1024 * 1024
        except OSError:
            return True

    @staticmethod
    def _devices_ok() -> bool:
        """A CUDA build needs a card; a CPU-only build runs on the CPU."""
        if torch.version.cuda is None:
            return True
        return torch.cuda.device_count() > 0

    def check(self) -> Dict[str, Any]:
        results = {}
        for name, hc in self._checks.items():
            try:
                ok = bool(hc.check())
            except Exception as exc:  # noqa: BLE001 - a failing check reports unhealthy
                ok = False
                logger.warning("health check %s raised: %s", name, exc)
            results[name] = ok
        return {"healthy": all(results.values()), "checks": results, "timestamp": time.time()}


GLOBAL_HEALTH = HealthChecker()


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the card's kernels too, where
    there is one), written under ``log_dir`` for TensorBoard."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
