"""Resilience primitives (counterpart of the JAX package's
``utils/resilience.py``): a three-state circuit breaker, exponential-backoff
retry with jitter, a bulkhead that bounds concurrent calls, an executor that
combines retry, breaker and fallback, decorator shortcuts and a named
registry. Host-only; ``ResilientTrainer`` retries training steps with
``RetryPolicy``.
"""

from __future__ import annotations

import functools
import random
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional, Tuple, Type

from .exceptions import ResourceError
from .logging import get_logger

logger = get_logger("resilience")


class CircuitState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreakerOpen(ResourceError):
    """Raised when a call is rejected by an open circuit."""


class CircuitBreaker:
    """Three-state circuit breaker: ``failure_threshold`` failures in a row
    open it; after ``recovery_timeout`` seconds it lets
    ``half_open_max_calls`` calls through, and one success closes it."""

    def __init__(self, failure_threshold: int = 5, recovery_timeout: float = 30.0,
                 half_open_max_calls: int = 1, name: str = "circuit"):
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = half_open_max_calls
        self.name = name
        self._state = CircuitState.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_calls = 0
        self._lock = threading.RLock()
        self.stats = {"calls": 0, "failures": 0, "rejected": 0, "transitions": 0}

    @property
    def state(self) -> CircuitState:
        with self._lock:
            if (self._state == CircuitState.OPEN
                    and time.monotonic() - self._opened_at >= self.recovery_timeout):
                self._transition(CircuitState.HALF_OPEN)
            return self._state

    def _transition(self, new: CircuitState) -> None:
        if new != self._state:
            logger.info("circuit %s: %s -> %s", self.name, self._state.value, new.value)
            self._state = new
            self.stats["transitions"] += 1
            if new == CircuitState.HALF_OPEN:
                self._half_open_calls = 0

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        with self._lock:
            state = self.state
            if state == CircuitState.OPEN:
                self.stats["rejected"] += 1
                raise CircuitBreakerOpen(f"circuit {self.name} is open")
            if state == CircuitState.HALF_OPEN:
                if self._half_open_calls >= self.half_open_max_calls:
                    self.stats["rejected"] += 1
                    raise CircuitBreakerOpen(f"circuit {self.name} half-open limit")
                self._half_open_calls += 1
            self.stats["calls"] += 1
        try:
            result = fn(*args, **kwargs)
        except Exception:
            with self._lock:
                self._failures += 1
                self.stats["failures"] += 1
                if (self._state == CircuitState.HALF_OPEN
                        or self._failures >= self.failure_threshold):
                    self._transition(CircuitState.OPEN)
                    self._opened_at = time.monotonic()
            raise
        with self._lock:
            if self._state == CircuitState.HALF_OPEN:
                self._transition(CircuitState.CLOSED)
            self._failures = 0
        return result

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        return wrapper

    def reset(self) -> None:
        with self._lock:
            self._transition(CircuitState.CLOSED)
            self._failures = 0


@dataclass
class RetryPolicy:
    """Exponential backoff with jitter: attempt ``a`` waits
    ``min(base_delay * backoff**a, max_delay) * (1 +- jitter)`` seconds."""

    max_attempts: int = 3
    base_delay: float = 0.1
    max_delay: float = 10.0
    backoff: float = 2.0
    jitter: float = 0.1
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    def delay_for(self, attempt: int) -> float:
        d = min(self.base_delay * self.backoff ** attempt, self.max_delay)
        return d * (1.0 + random.uniform(-self.jitter, self.jitter))

    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:  # noqa: PERF203
                last = exc
                if attempt + 1 < self.max_attempts:
                    delay = self.delay_for(attempt)
                    logger.warning("retry %d/%d after %.2fs: %s", attempt + 1,
                                   self.max_attempts, delay, exc)
                    time.sleep(delay)
        raise last  # type: ignore[misc]

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return self.execute(fn, *args, **kwargs)
        return wrapper


class BulkheadExecutor:
    """Concurrency isolation: at most ``max_concurrent`` calls at once; a
    call that waits longer than ``timeout`` (0: forever) is refused."""

    def __init__(self, max_concurrent: int = 4, timeout: float = 0.0,
                 name: str = "bulkhead"):
        self._sem = threading.Semaphore(max_concurrent)
        self.timeout = timeout
        self.name = name
        self.stats = {"accepted": 0, "rejected": 0}

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        acquired = self._sem.acquire(timeout=self.timeout if self.timeout else None)
        if not acquired:
            self.stats["rejected"] += 1
            raise ResourceError(f"bulkhead {self.name} full")
        self.stats["accepted"] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._sem.release()


class ResilientExecutor:
    """Retry + circuit breaker + optional fallback."""

    def __init__(self, retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 fallback: Optional[Callable] = None):
        self.retry = retry or RetryPolicy()
        self.breaker = breaker
        self.fallback = fallback

    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        target = fn
        if self.breaker is not None:
            target = functools.partial(self.breaker.call, fn)
        try:
            return self.retry.execute(target, *args, **kwargs)
        except Exception:
            if self.fallback is not None:
                logger.warning("falling back for %s", getattr(fn, "__name__", fn))
                return self.fallback(*args, **kwargs)
            raise


def with_retry(max_attempts: int = 3, base_delay: float = 0.1, **kw) -> Callable:
    """Decorator shortcut: a ``RetryPolicy``."""
    return RetryPolicy(max_attempts=max_attempts, base_delay=base_delay, **kw)


def with_circuit_breaker(failure_threshold: int = 5, **kw) -> CircuitBreaker:
    """Decorator shortcut: a ``CircuitBreaker``."""
    return CircuitBreaker(failure_threshold=failure_threshold, **kw)


class ResilienceManager:
    """Named registry of breakers and retry policies."""

    def __init__(self):
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._policies: Dict[str, RetryPolicy] = {}

    def breaker(self, name: str, **kw) -> CircuitBreaker:
        if name not in self._breakers:
            self._breakers[name] = CircuitBreaker(name=name, **kw)
        return self._breakers[name]

    def policy(self, name: str, **kw) -> RetryPolicy:
        if name not in self._policies:
            self._policies[name] = RetryPolicy(**kw)
        return self._policies[name]

    def status(self) -> Dict[str, Any]:
        return {name: {"state": b.state.value, **b.stats}
                for name, b in self._breakers.items()}


GLOBAL_RESILIENCE = ResilienceManager()
