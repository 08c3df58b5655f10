"""Rate limiting for the inference server: a token bucket keyed by caller
(counterpart of ``RateLimiter`` in the JAX package's ``utils/security.py``;
the rest of that module is not ported)."""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

from .exceptions import SecurityError


class RateLimiter:
    """Token bucket per caller: ``rate`` tokens a second, at most ``burst``
    held; a request takes one token."""

    def __init__(self, rate: float = 10.0, burst: int = 20):
        self.rate = rate
        self.burst = burst
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self._lock = threading.Lock()

    def allow(self, key: str = "default") -> bool:
        now = time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get(key, (float(self.burst), now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return True
            self._buckets[key] = (tokens, now)
            return False

    def check(self, key: str = "default") -> None:
        if not self.allow(key):
            raise SecurityError("rate limit exceeded", {"key": key})
