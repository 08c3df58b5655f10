"""Node registry, heartbeats and task placement over a local worker pool
(counterpart of the JAX package's ``quantum/distributed.py``).

Nodes live in an in-process key-value store with expiry (``ClusterKV``, the
reference's Redis). A task goes to a node by round robin, by the best score
(least loaded, or capability match after the filter), or by a softmax draw
over the scores (``QUANTUM_ANNEALING``, numpy's generator from ``seed``); it
runs on the local ``DistributedTaskScheduler`` once its dependencies
resolved. The local node's capabilities are ``["cpu", "cuda"]`` where a
card is visible (the JAX package probes ``"tpu"``).
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.distributed_processing import DistributedTaskScheduler
from ..utils.logging import get_logger

logger = get_logger("quantum.distributed")


class NodeType(Enum):
    COORDINATOR = "coordinator"
    WORKER = "worker"
    HYBRID = "hybrid"


class TaskDistributionStrategy(Enum):
    ROUND_ROBIN = "round_robin"
    LEAST_LOADED = "least_loaded"
    CAPABILITY_MATCH = "capability_match"
    QUANTUM_ANNEALING = "quantum_annealing"  # a softmax draw over the scores


@dataclass
class ComputeNode:
    node_id: str
    node_type: NodeType = NodeType.WORKER
    host: str = "localhost"
    port: int = 0
    capabilities: List[str] = field(default_factory=lambda: ["cpu"])
    max_concurrent_tasks: int = 4
    current_load: float = 0.0
    last_heartbeat: float = field(default_factory=time.time)
    is_active: bool = True
    performance_score: float = 1.0

    def score(self) -> float:
        """Higher is a better target: performance times free capacity."""
        return self.performance_score * (1.0 - min(self.current_load, 1.0))


@dataclass
class DistributedTask:
    task_id: str
    fn: Callable
    args: tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    priority: int = 5
    required_capabilities: List[str] = field(default_factory=list)
    dependencies: List[str] = field(default_factory=list)
    assigned_node: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    completed_at: Optional[float] = None
    error: Optional[str] = None


class ClusterKV:
    """A thread-safe key-value store whose entries may expire."""

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.RLock()

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        with self._lock:
            self._data[key] = value
            if ttl_s is not None:
                self._expiry[key] = time.time() + ttl_s
            else:
                self._expiry.pop(key, None)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            exp = self._expiry.get(key)
            if exp is not None and time.time() > exp:
                self._data.pop(key, None)
                self._expiry.pop(key, None)
                return default
            return self._data.get(key, default)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            now = time.time()
            out = []
            for k in list(self._data):
                exp = self._expiry.get(k)
                if exp is not None and now > exp:
                    self._data.pop(k, None)
                    self._expiry.pop(k, None)
                    continue
                if k.startswith(prefix):
                    out.append(k)
            return out

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._expiry.pop(key, None)


class QuantumDistributedManager:
    """Registered nodes are placement targets; every task executes on this
    process's worker pool (as the reference simulates remote execution). A
    heartbeat thread refreshes the local node's load and expiry;
    ``shutdown`` (or leaving the ``with`` block) stops it and the pool."""

    def __init__(self, node_type: NodeType = NodeType.HYBRID,
                 strategy: TaskDistributionStrategy = TaskDistributionStrategy.LEAST_LOADED,
                 num_workers: int = 4, heartbeat_interval_s: float = 5.0,
                 node_ttl_s: float = 30.0, annealing_temperature: float = 0.5,
                 seed: int = 0, capabilities: Optional[List[str]] = None) -> None:
        self.strategy = strategy
        self.kv = ClusterKV()
        self.heartbeat_interval_s = heartbeat_interval_s
        self.node_ttl_s = node_ttl_s
        self.annealing_temperature = annealing_temperature
        self._rng = np.random.default_rng(seed)
        self._rr_counter = 0
        self._scheduler = DistributedTaskScheduler(num_workers=num_workers)
        self._tasks: Dict[str, DistributedTask] = {}
        self._futures: Dict[str, Future] = {}
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self.local_node = ComputeNode(
            node_id=f"node-{uuid.uuid4().hex[:8]}", node_type=node_type,
            max_concurrent_tasks=num_workers,
            capabilities=capabilities or _probe_capabilities())
        self.register_node(self.local_node)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
        self._hb_thread.start()

    def register_node(self, node: ComputeNode) -> None:
        self.kv.set(f"nodes/{node.node_id}", node, ttl_s=self.node_ttl_s)
        logger.info("registered node %s (%s)", node.node_id, node.node_type.value)

    def active_nodes(self) -> List[ComputeNode]:
        nodes = [self.kv.get(k) for k in self.kv.keys("nodes/")]
        return [n for n in nodes if n is not None and n.is_active]

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.wait(self.heartbeat_interval_s):
            self.send_heartbeat()

    def send_heartbeat(self) -> None:
        with self._lock:
            running = sum(1 for t in self._tasks.values()
                          if t.started_at and not t.completed_at)
            self.local_node.current_load = running / max(self.local_node.max_concurrent_tasks, 1)
        self.local_node.last_heartbeat = time.time()
        self.register_node(self.local_node)  # refreshes the expiry

    def cleanup_stale_nodes(self) -> int:
        """Expired nodes are already hidden; how many entries that removed."""
        before = len(self.kv.keys("nodes/"))
        return before - len(self.active_nodes())

    def _select_node(self, task: DistributedTask) -> Optional[ComputeNode]:
        nodes = self.active_nodes()
        if task.required_capabilities:
            nodes = [n for n in nodes if set(task.required_capabilities) <= set(n.capabilities)]
        if not nodes:
            return None
        nodes.sort(key=lambda n: n.node_id)
        if self.strategy == TaskDistributionStrategy.ROUND_ROBIN:
            node = nodes[self._rr_counter % len(nodes)]
            self._rr_counter += 1
            return node
        if self.strategy == TaskDistributionStrategy.QUANTUM_ANNEALING:
            scores = np.array([n.score() for n in nodes], np.float64)
            logits = scores / max(self.annealing_temperature, 1e-6)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            return nodes[int(self._rng.choice(len(nodes), p=p))]
        # LEAST_LOADED, and CAPABILITY_MATCH after the filter: the best score
        return max(nodes, key=lambda n: n.score())

    def submit_task(self, fn: Callable, *args, priority: int = 5,
                    required_capabilities: Optional[List[str]] = None,
                    dependencies: Optional[List[str]] = None, **kwargs) -> str:
        """Place the task and queue it once every dependency has resolved; a
        failed dependency fails it. Raises ``RuntimeError`` when no active
        node has the capabilities, ``ValueError`` for an unknown dependency."""
        task = DistributedTask(task_id=f"task-{uuid.uuid4().hex[:12]}", fn=fn, args=args,
                               kwargs=kwargs, priority=priority,
                               required_capabilities=required_capabilities or [],
                               dependencies=dependencies or [])
        node = self._select_node(task)
        if node is None:
            raise RuntimeError(f"no active node satisfies capabilities "
                               f"{task.required_capabilities}")
        task.assigned_node = node.node_id
        with self._lock:
            unknown = [d for d in task.dependencies if d not in self._futures]
            if unknown:
                raise ValueError(f"unknown dependency task ids: {unknown}")
            dep_futures = [self._futures[d] for d in task.dependencies]
            # the caller's future exists at once; the task reaches the pool only
            # when its dependencies resolved (a worker waiting on one could
            # starve the pool)
            proxy: Future = Future()
            self._tasks[task.task_id] = task
            self._futures[task.task_id] = proxy

        remaining = [len(dep_futures)]
        cb_lock = threading.Lock()

        def _finish(result: Any = None, exc: Optional[BaseException] = None):
            try:
                if exc is not None:
                    proxy.set_exception(exc)
                else:
                    proxy.set_result(result)
            except InvalidStateError:   # already resolved (two dependencies failed)
                pass

        def _launch():
            real = self._scheduler.submit(self._run_task, task, priority=priority)
            real.add_done_callback(lambda f: _finish(exc=f.exception())
                                   if f.exception() is not None else _finish(result=f.result()))

        def _dep_done(f: Future):
            dep_exc = f.exception()
            if dep_exc is not None:
                task.error = f"dependency failed: {dep_exc}"
                task.completed_at = time.time()
                _finish(exc=RuntimeError(f"task {task.task_id} dependency failed: {dep_exc}"))
                return
            with cb_lock:
                remaining[0] -= 1
                ready = remaining[0] == 0
            if ready:
                _launch()

        if not dep_futures:
            _launch()
        else:
            for d in dep_futures:
                d.add_done_callback(_dep_done)
        return task.task_id

    def _run_task(self, task: DistributedTask) -> Any:
        task.started_at = time.time()
        try:
            return task.fn(*task.args, **task.kwargs)
        except Exception as exc:
            task.error = str(exc)
            raise
        finally:
            task.completed_at = time.time()

    def get_result(self, task_id: str, timeout: Optional[float] = None) -> Any:
        with self._lock:
            fut = self._futures.get(task_id)
        if fut is None:
            raise KeyError(f"unknown task {task_id}")
        return fut.result(timeout=timeout)

    def wait_all(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            futs = list(self._futures.values())
        for f in futs:
            f.exception(timeout=timeout)  # raised later by get_result

    def get_cluster_status(self) -> Dict[str, Any]:
        with self._lock:
            tasks = list(self._tasks.values())
        done = [t for t in tasks if t.completed_at is not None]
        return {
            "nodes": {n.node_id: {"type": n.node_type.value, "load": round(n.current_load, 3),
                                  "capabilities": n.capabilities,
                                  "performance_score": n.performance_score,
                                  "heartbeat_age_s": round(time.time() - n.last_heartbeat, 2)}
                      for n in self.active_nodes()},
            "strategy": self.strategy.value,
            "tasks": {"total": len(tasks), "completed": len(done),
                      "failed": sum(1 for t in done if t.error),
                      "running": sum(1 for t in tasks if t.started_at and not t.completed_at)},
        }

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown.set()
        self._scheduler.shutdown(wait=wait)
        self._hb_thread.join(timeout=2.0)

    def __enter__(self) -> "QuantumDistributedManager":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _probe_capabilities() -> List[str]:
    """``["cpu"]``, plus ``"cuda"`` where a card is visible."""
    return ["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"]
