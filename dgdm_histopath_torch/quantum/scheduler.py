"""Job scheduler over the task planner, with resource sampling (counterpart
of the JAX package's ``quantum/scheduler.py``).

``read_resources`` takes the load average and host memory from /proc and
the card's memory from ``utils.monitoring.device_memory_stats`` (the CUDA
allocator's bytes in use, each card's total). A failure to read the card
raises: the JAX package's ``except Exception: pass`` around its device
read is not copied. Without a card the device fields are 0.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import get_logger
from ..utils.monitoring import device_memory_stats
from .planner import QuantumTaskPlanner, TaskPriority

logger = get_logger("quantum")


class SchedulingStrategy(Enum):
    FIFO = "fifo"
    PRIORITY = "priority"
    RESOURCE_AWARE = "resource_aware"
    ANNEALED = "annealed"        # the reference's "quantum_optimized"


@dataclass
class ResourceSnapshot:
    timestamp: float
    cpu_load_1m: float
    mem_available_mb: float
    mem_total_mb: float
    device_mem_used_mb: float = 0.0
    device_mem_total_mb: float = 0.0

    @property
    def mem_used_fraction(self) -> float:
        if self.mem_total_mb <= 0:
            return 0.0
        return 1.0 - self.mem_available_mb / self.mem_total_mb


def read_resources() -> ResourceSnapshot:
    """Load average and memory from /proc, the cards' memory in MB (1e6 bytes)."""
    cpu = 0.0
    try:
        with open("/proc/loadavg") as f:
            cpu = float(f.read().split()[0])
    except OSError:  # pragma: no cover - no /proc
        pass
    avail = total = 0.0
    try:
        with open("/proc/meminfo") as f:
            info = {line.split(":")[0]: float(line.split()[1]) for line in f if ":" in line}
        avail = info.get("MemAvailable", 0.0) / 1024.0
        total = info.get("MemTotal", 0.0) / 1024.0
    except OSError:  # pragma: no cover - no /proc
        pass
    dev_used = dev_total = 0.0
    for stats in device_memory_stats().values():
        dev_used += stats["bytes_in_use"] / 1e6
        dev_total += stats["bytes_limit"] / 1e6
    return ResourceSnapshot(time.time(), cpu, avail, total, dev_used, dev_total)


@dataclass
class Job:
    job_id: str
    name: str
    fn: Callable
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    priority: TaskPriority = TaskPriority.MEDIUM
    min_free_mem_mb: float = 0.0
    max_cpu_load: float = 1e9
    recurring_interval: Optional[float] = None
    status: str = "queued"
    result: Any = None
    error: Optional[str] = None
    runs: int = 0


class QuantumScheduler:
    """Job scheduler with a background resource monitor (a context manager
    starts and stops it). ``RESOURCE_AWARE`` defers a job that asks for more
    free host memory than the last snapshot shows, or a lower load."""

    def __init__(self, max_workers: int = 4,
                 strategy: SchedulingStrategy | str = SchedulingStrategy.PRIORITY,
                 monitor_interval: float = 5.0):
        if isinstance(strategy, str):
            strategy = SchedulingStrategy(strategy)
        self.strategy = strategy
        self.max_workers = max_workers
        self.monitor_interval = monitor_interval
        self.jobs: Dict[str, Job] = {}
        self.resource_history: List[ResourceSnapshot] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None

    def start_monitoring(self) -> None:
        if self._monitor_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.monitor_interval):
                snap = read_resources()
                with self._lock:
                    self.resource_history.append(snap)
                    if len(self.resource_history) > 720:
                        self.resource_history = self.resource_history[-720:]

        self._monitor_thread = threading.Thread(target=loop, daemon=True)
        self._monitor_thread.start()

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2.0)
            self._monitor_thread = None

    def current_resources(self) -> ResourceSnapshot:
        with self._lock:
            if self.resource_history:
                return self.resource_history[-1]
        return read_resources()

    def submit(self, name: str, fn: Callable, *args,
               priority: TaskPriority | str = TaskPriority.MEDIUM,
               min_free_mem_mb: float = 0.0, max_cpu_load: float = 1e9,
               recurring_interval: Optional[float] = None, **kwargs) -> str:
        if isinstance(priority, str):
            priority = TaskPriority[priority.upper()]
        jid = str(uuid.uuid4())[:8]
        with self._lock:
            self.jobs[jid] = Job(jid, name, fn, args, kwargs, priority, min_free_mem_mb,
                                 max_cpu_load, recurring_interval)
        return jid

    def _resource_ok(self, job: Job) -> bool:
        snap = self.current_resources()
        if snap.mem_available_mb and job.min_free_mem_mb > snap.mem_available_mb:
            return False
        return not snap.cpu_load_1m > job.max_cpu_load

    def _order(self, jobs: List[Job]) -> List[Job]:
        if self.strategy == SchedulingStrategy.FIFO:
            return jobs
        if self.strategy in (SchedulingStrategy.PRIORITY, SchedulingStrategy.RESOURCE_AWARE):
            return sorted(jobs, key=lambda j: -j.priority.value)
        planner = QuantumTaskPlanner(max_workers=self.max_workers)
        ids = {planner.add_task(j.name, priority=j.priority): j for j in jobs}
        return [ids[t] for t in planner.plan()]

    def run_pending(self, timeout: Optional[float] = None) -> Dict[str, Job]:
        """Run every queued job under the strategy; a deferred job keeps
        status ``"deferred"``."""
        with self._lock:
            queue = [j for j in self.jobs.values() if j.status == "queued"]
        ordered = self._order(queue)
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futures = {}
            for job in ordered:
                if timeout and time.monotonic() - t0 > timeout:
                    break
                if (self.strategy == SchedulingStrategy.RESOURCE_AWARE
                        and not self._resource_ok(job)):
                    job.status = "deferred"
                    logger.info("job %s deferred (resources)", job.name)
                    continue
                job.status = "running"
                futures[pool.submit(self._run, job)] = job
            for fut in futures:
                fut.result()
        return dict(self.jobs)

    @staticmethod
    def _run(job: Job) -> None:
        try:
            job.result = job.fn(*job.args, **job.kwargs)
            job.status = "completed"
        except Exception as exc:  # noqa: BLE001 - a job's failure is its status
            job.status = "failed"
            job.error = str(exc)
            logger.error("job %s failed: %s", job.name, exc)
        finally:
            job.runs += 1

    def status_summary(self) -> Dict[str, int]:
        with self._lock:
            return dict(Counter(j.status for j in self.jobs.values()))

    def __enter__(self):
        self.start_monitoring()
        return self

    def __exit__(self, *exc):
        self.stop_monitoring()
        return False
