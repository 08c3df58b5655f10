"""Performance utilities (counterpart of the JAX package's
``utils/optimization.py``): an adaptive LRU cache, a resource pool, a
thread-pool map, a background-thread prefetch, a compressed disk cache, and
the device side: ``clear_device_caches`` (the CUDA caching allocator) and
``device_put_prefetch`` (batches uploaded ahead of the consumer from pinned
memory on a side stream)."""

from __future__ import annotations

import functools
import hashlib
import pickle
import queue
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Generic, Iterable, Iterator, List, Optional, TypeVar

import torch

from .device import resolve_device
from .exceptions import ResourceError
from .logging import get_logger

logger = get_logger("optimization")

K = TypeVar("K")
V = TypeVar("V")


class AdaptiveCache(Generic[K, V]):
    """LRU cache with an optional TTL whose size follows its hit rate: every
    100th lookup doubles it above a 0.8 hit rate and halves it below 0.2."""

    def __init__(self, max_items: int = 256, ttl_s: Optional[float] = None,
                 adaptive: bool = True, min_items: int = 32, max_items_cap: int = 4096):
        self.max_items = max_items
        self.ttl_s = ttl_s
        self.adaptive = adaptive
        self.min_items = min_items
        self.max_items_cap = max_items_cap
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                self._maybe_resize()
                return None
            value, ts = entry
            if self.ttl_s is not None and time.monotonic() - ts > self.ttl_s:
                del self._store[key]
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: K, value: V) -> None:
        with self._lock:
            self._store[key] = (value, time.monotonic())
            self._store.move_to_end(key)
            while len(self._store) > self.max_items:
                self._store.popitem(last=False)

    def _maybe_resize(self) -> None:
        total = self.hits + self.misses
        if not self.adaptive or total < 100 or total % 100:
            return
        rate = self.hits / total
        if rate > 0.8 and self.max_items < self.max_items_cap:
            self.max_items = min(self.max_items * 2, self.max_items_cap)
        elif rate < 0.2 and self.max_items > self.min_items:
            self.max_items = max(self.max_items // 2, self.min_items)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


def cached(cache: Optional[AdaptiveCache] = None, key_fn: Optional[Callable] = None):
    """Decorator backed by an AdaptiveCache (a ``None`` result is not kept)."""
    cache = cache or AdaptiveCache()

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = key_fn(*args, **kwargs) if key_fn else (args, tuple(sorted(kwargs.items())))
            hit = cache.get(key)
            if hit is not None:
                return hit
            value = fn(*args, **kwargs)
            cache.put(key, value)
            return value
        wrapper.cache = cache
        return wrapper
    return deco


class ResourcePool(Generic[V]):
    """Bounded pool of reusable resources made by ``factory``."""

    def __init__(self, factory: Callable[[], V], max_size: int = 8):
        self._factory = factory
        self._sem = threading.Semaphore(max_size)
        self._free: List[V] = []
        self._lock = threading.Lock()
        self.created = 0

    def acquire(self, timeout: Optional[float] = None) -> V:
        if not self._sem.acquire(timeout=timeout):
            raise ResourceError("resource pool exhausted")
        with self._lock:
            if self._free:
                return self._free.pop()
            self.created += 1
        return self._factory()

    def release(self, resource: V) -> None:
        with self._lock:
            self._free.append(resource)
        self._sem.release()

    class _Ctx:
        def __init__(self, pool):
            self.pool = pool
            self.resource = None

        def __enter__(self):
            self.resource = self.pool.acquire()
            return self.resource

        def __exit__(self, *exc):
            self.pool.release(self.resource)
            return False

    def borrowed(self) -> "_Ctx":
        return self._Ctx(self)


class ParallelProcessor:
    """Thread-pool map with results in input order. ``error_policy``:
    ``"raise"`` the first failure, ``"none"`` puts None in its place,
    ``"skip"`` drops the failed items (and any None result)."""

    def __init__(self, max_workers: int = 8, error_policy: str = "raise"):
        self.max_workers = max_workers
        self.error_policy = error_policy

    def map(self, fn: Callable, items: Iterable) -> List[Any]:
        items = list(items)
        results: List[Any] = [None] * len(items)
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futures = {pool.submit(fn, item): i for i, item in enumerate(items)}
            for fut, i in futures.items():
                try:
                    results[i] = fut.result()
                except Exception as exc:  # noqa: BLE001 - the error policy decides
                    if self.error_policy == "raise":
                        raise
                    logger.error("item %d failed: %s", i, exc)
                    results[i] = None
        if self.error_policy == "skip":
            return [r for r in results if r is not None]
        return results


class PrefetchIterator(Iterator):
    """Runs ``iterable`` on a background thread, at most ``depth`` items
    ahead of the consumer. An exception in the producer is raised to the
    consumer when it reaches that point of the stream."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._error: List[BaseException] = []
        self._stopped = False

        def producer():
            try:
                for item in iterable:
                    if self._stopped:
                        break
                    self._q.put(item)
            except BaseException as exc:  # noqa: BLE001 - handed to the consumer
                self._error.append(exc)
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            self._thread.join()
            if self._error:
                raise self._error[0]
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer without exhausting the stream: set the stop
        flag, then drain until the producer's sentinel unblocks it."""
        if self._stopped:
            return
        self._stopped = True
        while self._thread.is_alive():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is self._sentinel:
                break
        self._thread.join(timeout=5.0)


class CompressedDataCache:
    """Disk cache of zlib-compressed pickles, one file a key. Safe only for
    data this process produced (it unpickles)."""

    def __init__(self, directory: str | Path, level: int = 4):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.level = level

    def _path(self, key: str) -> Path:
        return self.directory / (hashlib.sha1(key.encode()).hexdigest() + ".zpkl")

    def put(self, key: str, value: Any) -> None:
        self._path(key).write_bytes(zlib.compress(pickle.dumps(value, protocol=4), self.level))

    def get(self, key: str) -> Optional[Any]:
        p = self._path(key)
        if not p.exists():
            return None
        return pickle.loads(zlib.decompress(p.read_bytes()))

    def __contains__(self, key: str) -> bool:
        return self._path(key).exists()


def clear_device_caches() -> None:
    """Release the CUDA caching allocator's unused cached blocks (the
    JAX package clears its compile and array caches here). The kernels'
    libraries stay loaded; before CUDA is initialized there is nothing to
    clear."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], batch: Any) -> Any:
    """``batch`` with ``fn`` applied to each of its tensors: a tensor, a
    ``PaddedGraph`` (anything with ``replace`` and tensor fields), or a
    dict, list or tuple of these."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map_tensors(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(fn, v) for v in batch)
    if hasattr(batch, "tensors") and hasattr(batch, "replace"):
        return batch.replace(**{k: fn(v) for k, v in vars(batch).items()
                                if isinstance(v, torch.Tensor)})
    return batch


class _DevicePrefetch(PrefetchIterator):
    """``PrefetchIterator`` whose producer uploads each batch; ``__next__``
    makes the consumer's stream wait for that upload."""

    def __init__(self, batches: Iterable, device: torch.device, depth: int):
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        super().__init__((self._upload(b) for b in batches), depth=depth)

    def _upload(self, batch):
        if self._stream is None:
            return _map_tensors(lambda t: t.to(self._device), batch), None
        pinned = _map_tensors(lambda t: t if t.is_cuda else t.pin_memory(), batch)
        with torch.cuda.stream(self._stream):
            on_device = _map_tensors(lambda t: t.to(self._device, non_blocking=True), pinned)
            uploaded = torch.cuda.Event()
            uploaded.record()
        return on_device, uploaded

    def __next__(self):
        batch, uploaded = super().__next__()
        if uploaded is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(uploaded)
            # the upload's memory is not reused before this stream's work on it
            _map_tensors(lambda t: t.record_stream(stream) or t, batch)
        return batch


def device_put_prefetch(batches: Iterable, device=None, depth: int = 2) -> Iterator:
    """Yield each batch of ``batches`` on ``device`` (``None``: the card),
    uploaded up to ``depth`` batches ahead on a background thread: on the
    card from pinned memory on a side stream, each batch ready for the
    consumer's stream when it is yielded (as ``DGDMTrainer.fit`` feeds its
    steps)."""
    return _DevicePrefetch(batches, resolve_device(device), depth)
