"""Dynamic request batching for the inference server (counterpart of the JAX
package's ``deployment/batching.py``).

The card runs one queue of work, so the server's shape under load is many IO
threads accepting requests and ONE device thread running batched calls.
Concurrent ``/predict`` requests park on futures while the batcher drains the
queue (up to ``max_batch`` requests or ``max_wait_ms``, whichever comes
first) and runs them as one ``DGDMPredictor.predict_batch`` call, whose
same-bucket graphs stack into one forward. The host's launches per forward
are spread over the batch; the cost is a bounded queueing delay under light
load.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Sequence

from ..utils.logging import get_logger

logger = get_logger("batching")


class DynamicBatcher:
    """Coalesce concurrent single-item requests into batched calls.

    ``batch_fn``: callable taking a list of items and returning a list of
    results of the same length and order. It runs on the batcher's own
    thread, the only thread that should touch the device.
    """

    def __init__(self, batch_fn: Callable[[Sequence[Any]], List[Any]],
                 max_batch: int = 16, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_fn = batch_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q: "Queue" = Queue()
        self._closed = False
        # serializes the closed-check + enqueue in submit() against the
        # set-closed + stop marker in close(): without it a submit that read
        # _closed=False could enqueue after close()'s marker and after the
        # batcher thread's final drain, leaving its future unresolved
        self._submit_lock = threading.Lock()
        self.stats: Dict[str, float] = {"batches": 0, "items": 0, "max_batch_seen": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True, name="dgdm-batcher")
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, item: Any) -> Future:
        """Enqueue one item; resolve via the returned future."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((item, fut))
        return fut

    def __call__(self, item: Any, timeout: float = 60.0) -> Any:
        """Blocking convenience: submit and wait for the result."""
        return self.submit(item).result(timeout=timeout)

    # -- device side -------------------------------------------------------
    def _drain(self) -> List:
        """Block for the first request, then collect followers until the
        batch is full or the wait window closes."""
        try:
            first = self._q.get(timeout=0.2)
        except Empty:
            return []
        if first is None:
            return [None]
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except Empty:
                break
            if nxt is None:
                batch.append(None)
                break
            batch.append(nxt)
        return batch

    def _run(self, items: List[Any], futs: List[Future]) -> None:
        """One batch; when it fails, each item again on its own, so that only
        a bad item's waiter gets the error."""
        try:
            results = self.batch_fn(items)
            if len(results) != len(items):
                raise RuntimeError(f"batch_fn returned {len(results)} results "
                                   f"for {len(items)} items")
            for f, r in zip(futs, results):
                f.set_result(r)
        except BaseException as exc:  # noqa: BLE001 - handed to the waiters
            if len(items) == 1:
                if not futs[0].done():
                    futs[0].set_exception(exc)
                return
            logger.warning("batch of %d failed (%s); retrying items individually",
                           len(items), exc)
            for item, f in zip(items, futs):
                if f.done():
                    continue
                try:
                    r = self.batch_fn([item])
                    if len(r) != 1:
                        raise RuntimeError(f"batch_fn returned {len(r)} results for 1 item")
                    f.set_result(r[0])
                except BaseException as exc1:  # noqa: BLE001 - handed to the waiter
                    f.set_exception(exc1)

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                if self._closed:
                    return
                continue
            stop = batch[-1] is None
            if stop:
                batch = batch[:-1]
            if batch:
                items = [b[0] for b in batch]
                self._run(items, [b[1] for b in batch])
                self.stats["batches"] += 1
                self.stats["items"] += len(items)
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(items))
            if stop:
                # fail anything that raced close(): an item behind the stop
                # marker would otherwise never resolve
                while True:
                    try:
                        entry = self._q.get_nowait()
                    except Empty:
                        break
                    if entry is not None:
                        entry[1].set_exception(RuntimeError("batcher is closed"))
                return

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Drain outstanding requests and stop the device thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake + stop marker
        self._thread.join(timeout=timeout)

    @property
    def mean_batch_size(self) -> float:
        return self.stats["items"] / max(self.stats["batches"], 1)
