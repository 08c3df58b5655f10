"""Local task processing on one host: a load balancer, a priority-queue
thread pool, a cluster facade, a decorator and batch fan-out
(counterpart of the JAX package's ``utils/distributed_processing.py``).

The "cluster" is a pool of threads in one process. It fans slide-level,
host-bound work (decode, tiling, writing) out, e.g.
``SlideDataset.preprocess_all(num_workers > 1)``; device parallelism lives in
``parallel/``.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from .logging import get_logger

logger = get_logger("distributed")


@dataclass
class WorkerNode:
    node_id: str
    capacity: int = 4
    active: int = 0
    completed: int = 0
    failed: int = 0
    total_latency_s: float = 0.0

    @property
    def load(self) -> float:
        return self.active / max(self.capacity, 1)

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / self.completed if self.completed else 0.0


class IntelligentLoadBalancer:
    """Pick the least-loaded node, the next in turn, or the fastest."""

    def __init__(self, strategy: str = "least_loaded"):
        if strategy not in ("least_loaded", "round_robin", "fastest"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.nodes: Dict[str, WorkerNode] = {}
        self._rr = 0
        self._lock = threading.Lock()

    def register(self, node_id: str, capacity: int = 4) -> WorkerNode:
        with self._lock:
            node = WorkerNode(node_id, capacity)
            self.nodes[node_id] = node
            return node

    def select(self) -> WorkerNode:
        with self._lock:
            if not self.nodes:
                raise RuntimeError("no worker nodes registered")
            nodes = list(self.nodes.values())
            if self.strategy == "round_robin":
                node = nodes[self._rr % len(nodes)]
                self._rr += 1
                return node
            if self.strategy == "fastest":
                return min(nodes, key=lambda n: (n.mean_latency_s or 1e9, n.load))
            return min(nodes, key=lambda n: n.load)

    def record(self, node: WorkerNode, ok: bool, latency_s: float) -> None:
        with self._lock:
            node.active = max(0, node.active - 1)
            if ok:
                node.completed += 1
                node.total_latency_s += latency_s
            else:
                node.failed += 1

    def status(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {nid: {"load": n.load, "completed": n.completed,
                          "failed": n.failed,
                          "mean_latency_s": n.mean_latency_s}
                    for nid, n in self.nodes.items()}


@dataclass(order=True)
class _PrioritizedTask:
    priority: int
    seq: int
    task_id: str = field(compare=False)
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())
    kwargs: dict = field(compare=False, default_factory=dict)
    future: Future = field(compare=False, default_factory=Future)


class DistributedTaskScheduler:
    """A priority queue served by ``num_workers`` threads, one balancer node
    each; a higher ``priority`` runs first, ties in submission order."""

    def __init__(self, num_workers: int = 4, balancer: Optional[IntelligentLoadBalancer] = None):
        self.balancer = balancer or IntelligentLoadBalancer()
        self._queue: "queue.PriorityQueue[_PrioritizedTask]" = queue.PriorityQueue()
        self._seq = 0
        self._shutdown = threading.Event()
        self._workers: List[threading.Thread] = []
        for i in range(num_workers):
            node = self.balancer.register(f"worker{i}", capacity=1)
            t = threading.Thread(target=self._worker_loop, args=(node,),
                                 daemon=True)
            t.start()
            self._workers.append(t)

    def submit(self, fn: Callable, *args, priority: int = 5, **kwargs) -> Future:
        if self._shutdown.is_set():
            raise RuntimeError("scheduler is shut down")
        self._seq += 1
        task = _PrioritizedTask(-priority, self._seq, str(uuid.uuid4())[:8],
                                fn, args, kwargs)
        self._queue.put(task)
        return task.future

    def _worker_loop(self, node: WorkerNode) -> None:
        while not self._shutdown.is_set():
            try:
                task = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            node.active += 1
            t0 = time.perf_counter()
            try:
                result = task.fn(*task.args, **task.kwargs)
                task.future.set_result(result)
                self.balancer.record(node, True, time.perf_counter() - t0)
            except BaseException as exc:  # noqa: BLE001
                task.future.set_exception(exc)
                self.balancer.record(node, False, time.perf_counter() - t0)
            finally:
                self._queue.task_done()

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            self._queue.join()
        self._shutdown.set()
        for t in self._workers:
            t.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


class LocalCluster:
    """The scheduler and its balancer behind one object."""

    def __init__(self, num_workers: int = 4, strategy: str = "least_loaded"):
        self.balancer = IntelligentLoadBalancer(strategy)
        self.scheduler = DistributedTaskScheduler(num_workers, self.balancer)

    def submit(self, fn, *args, **kwargs) -> Future:
        return self.scheduler.submit(fn, *args, **kwargs)

    def map(self, fn: Callable, items: Iterable, priority: int = 5) -> List[Any]:
        futures = [self.scheduler.submit(fn, item, priority=priority)
                   for item in items]
        return [f.result() for f in futures]

    def status(self) -> Dict[str, Any]:
        return self.balancer.status()

    def shutdown(self) -> None:
        self.scheduler.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def create_local_cluster(num_workers: int = 4,
                         strategy: str = "least_loaded") -> LocalCluster:
    return LocalCluster(num_workers, strategy)


_DEFAULT_CLUSTER: Optional[LocalCluster] = None
_DEFAULT_LOCK = threading.Lock()


def _default_cluster() -> LocalCluster:
    global _DEFAULT_CLUSTER
    with _DEFAULT_LOCK:
        if _DEFAULT_CLUSTER is None:
            _DEFAULT_CLUSTER = create_local_cluster()
        return _DEFAULT_CLUSTER


def distributed_task(priority: int = 5):
    """Decorator: run the function through the default cluster; the call
    returns a Future (``.sync`` is the plain function)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> Future:
            return _default_cluster().submit(fn, *args, priority=priority,
                                             **kwargs)
        wrapper.sync = fn
        return wrapper
    return deco


def process_batch(fn: Callable, items: Sequence, num_workers: int = 4,
                  chunk_size: int = 1) -> List[Any]:
    """``[fn(x) for x in items]`` across a temporary cluster of
    ``num_workers`` threads, in the items' order (``chunk_size`` items a
    task); the first exception of a task is raised."""
    if chunk_size > 1:
        chunks = [list(items[i:i + chunk_size])
                  for i in range(0, len(items), chunk_size)]
        with create_local_cluster(num_workers) as cluster:
            chunk_results = cluster.map(lambda c: [fn(x) for x in c], chunks)
        return [r for chunk in chunk_results for r in chunk]
    with create_local_cluster(num_workers) as cluster:
        return cluster.map(fn, items)
