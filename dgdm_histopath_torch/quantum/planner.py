"""Task planner: priorities, dependencies and an annealed schedule
(counterpart of the JAX package's ``quantum/planner.py``).

Classical scheduling under the reference's names: a priority-weighted
topological order, then simulated annealing over swaps of the order against
the weighted completion time, repaired to respect dependencies. The draws
come from ``random.Random(seed)`` in the JAX package's order, so the same
tasks and seed give the same plan. ``execute`` runs the plan on a thread
pool that it shuts down before it returns.
"""

from __future__ import annotations

import math
import random
import threading
import time
import uuid
from collections import Counter
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils.exceptions import QuantumPlannerError
from ..utils.logging import get_logger

logger = get_logger("quantum")


class TaskPriority(Enum):
    CRITICAL = 4
    HIGH = 3
    MEDIUM = 2
    LOW = 1
    BACKGROUND = 0


class TaskStatus(Enum):
    PENDING = "pending"
    READY = "ready"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class Task:
    task_id: str
    name: str
    fn: Optional[Callable] = None
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    priority: TaskPriority = TaskPriority.MEDIUM
    dependencies: List[str] = field(default_factory=list)
    estimated_duration: float = 1.0
    resources: Dict[str, float] = field(default_factory=dict)
    status: TaskStatus = TaskStatus.PENDING
    result: Any = None
    error: Optional[str] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def weight(self) -> float:
        """2 ** priority: the weight of the task's completion time."""
        return float(2 ** self.priority.value)


class QuantumTaskPlanner:
    """Priority and dependency planner with an annealed order."""

    def __init__(self, max_workers: int = 4, anneal_iterations: int = 200, seed: int = 0):
        self.max_workers = max_workers
        self.anneal_iterations = anneal_iterations
        self.tasks: Dict[str, Task] = {}
        self._lock = threading.RLock()
        self._rng = random.Random(seed)

    def add_task(self, name: str, fn: Optional[Callable] = None, args: tuple = (),
                 kwargs: Optional[dict] = None,
                 priority: TaskPriority | str = TaskPriority.MEDIUM,
                 dependencies: Optional[Sequence[str]] = None,
                 estimated_duration: float = 1.0,
                 resources: Optional[Dict[str, float]] = None,
                 task_id: Optional[str] = None) -> str:
        if isinstance(priority, str):
            priority = TaskPriority[priority.upper()]
        tid = task_id or str(uuid.uuid4())[:8]
        with self._lock:
            for dep in dependencies or []:
                if dep not in self.tasks:
                    raise QuantumPlannerError("unknown dependency",
                                              {"task": name, "dependency": dep})
            self.tasks[tid] = Task(task_id=tid, name=name, fn=fn, args=args,
                                   kwargs=kwargs or {}, priority=priority,
                                   dependencies=list(dependencies or []),
                                   estimated_duration=estimated_duration,
                                   resources=dict(resources or {}))
        return tid

    def _schedule_cost(self, order: List[str]) -> float:
        """Σ weight · completion time over the order."""
        t = cost = 0.0
        for tid in order:
            task = self.tasks[tid]
            t += task.estimated_duration
            cost += t * task.weight
        return cost

    def _repair(self, order: List[str]) -> List[str]:
        """The order with each task moved after its dependencies (stable)."""
        placed: List[str] = []
        remaining = list(order)
        while remaining:
            progressed = False
            for tid in list(remaining):
                if all(d in placed for d in self.tasks[tid].dependencies):
                    placed.append(tid)
                    remaining.remove(tid)
                    progressed = True
            if not progressed:
                raise QuantumPlannerError("dependency cycle detected", {"remaining": remaining})
        return placed

    def plan(self) -> List[str]:
        """An execution order: the weighted topological order, then
        ``anneal_iterations`` random swaps, each repaired and kept when it
        lowers the cost (the acceptance draw is made as in the JAX package)."""
        with self._lock:
            if not self.tasks:
                return []
            best = self._repair(sorted(self.tasks, key=lambda t: -self.tasks[t].weight))
            best_cost = self._schedule_cost(best)
            temp = 1.0
            for _ in range(self.anneal_iterations):
                cand = list(best)
                i = self._rng.randrange(len(cand))
                j = self._rng.randrange(len(cand))
                cand[i], cand[j] = cand[j], cand[i]
                try:
                    cand = self._repair(cand)
                except QuantumPlannerError:
                    continue
                cost = self._schedule_cost(cand)
                if cost < best_cost or self._rng.random() < math.exp(
                        -(cost - best_cost) / max(temp, 1e-9)):
                    if cost < best_cost:
                        best, best_cost = cand, cost
                temp *= 0.98
            return best

    def execute(self, order: Optional[List[str]] = None,
                timeout: Optional[float] = None) -> Dict[str, Task]:
        """Run the tasks in ``order`` (default: :meth:`plan`) on a thread pool,
        each once its dependencies completed; a task whose dependency failed
        is cancelled, and so is every task still pending at ``timeout``."""
        order = order or self.plan()
        done: set = set()
        failed: set = set()
        t_start = time.monotonic()
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            pending = list(order)
            futures: Dict[Any, str] = {}
            while pending or futures:
                if timeout is not None and time.monotonic() - t_start > timeout:
                    for tid in pending:
                        self.tasks[tid].status = TaskStatus.CANCELLED
                    break
                launched = []
                for tid in pending:
                    task = self.tasks[tid]
                    deps = set(task.dependencies)
                    if deps & failed:
                        task.status = TaskStatus.CANCELLED
                        task.error = "dependency failed"
                        failed.add(tid)
                        launched.append(tid)
                        continue
                    if deps <= done:
                        task.status = TaskStatus.RUNNING
                        task.started_at = time.monotonic()
                        futures[pool.submit(self._run_task, task)] = tid
                        launched.append(tid)
                for tid in launched:
                    pending.remove(tid)
                if futures:
                    finished, _ = wait(list(futures), timeout=0.1, return_when=FIRST_COMPLETED)
                    for fut in finished:
                        tid = futures.pop(fut)
                        if self.tasks[tid].status == TaskStatus.COMPLETED:
                            done.add(tid)
                        else:
                            failed.add(tid)
                elif pending:
                    time.sleep(0.01)
        return dict(self.tasks)

    @staticmethod
    def _run_task(task: Task) -> None:
        try:
            if task.fn is not None:
                task.result = task.fn(*task.args, **task.kwargs)
            task.status = TaskStatus.COMPLETED
        except Exception as exc:  # noqa: BLE001 - a task's failure is its status
            task.status = TaskStatus.FAILED
            task.error = str(exc)
            logger.error("task %s failed: %s", task.name, exc)
        finally:
            task.finished_at = time.monotonic()

    def status_summary(self) -> Dict[str, int]:
        return dict(Counter(t.status.value for t in self.tasks.values()))


# the reference exports the planner under this name
QuantumPlanner = QuantumTaskPlanner
