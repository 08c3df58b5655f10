"""Host-side pipelining: a background-thread prefetch over an iterator
(counterpart of the JAX package's ``utils/optimization.py``
``PrefetchIterator``)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List


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
