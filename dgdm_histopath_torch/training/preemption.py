"""Cooperative preemption handling for training jobs (counterpart of the JAX
package's ``training/preemption.py``).

Batch schedulers deliver SIGTERM a short grace window before a machine is
reclaimed. The signal only flips a flag, with no work in the handler, and
``DGDMTrainer.fit`` reads the flag at the next step boundary, writes an
emergency checkpoint tagged with the exact (epoch, step-in-epoch) position,
and returns cleanly.

Resume is bit-identical: each step's draws come from ``(seed, step)``, the
checkpoint holds the parameters, the AdamW moments, ``step`` and ``seed``,
and the fit loop skips the first ``step_in_epoch`` batches of the
deterministic loader, so the resumed run replays the remaining steps.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Tuple

from ..utils.logging import get_logger

logger = get_logger("preemption")


class PreemptionGuard:
    """Signal-to-flag bridge for graceful train-loop shutdown.

    Usage::

        guard = PreemptionGuard()           # installs SIGTERM by default
        trainer.fit(..., preemption_guard=guard)

    The handler is async-signal-safe (sets a ``threading.Event`` and
    returns); the expensive work — checkpointing and teardown — runs in the
    training loop's own thread at a step boundary. ``trigger()`` lets tests
    and external schedulers (e.g. a borg/k8s preStop hook calling into the
    process) request the same graceful stop without a signal.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,),
                 install: bool = True):
        self._event = threading.Event()
        self._signals = tuple(signals)
        self._previous = {}
        self._installed = False
        if install:
            self.install()

    # -- handler management ------------------------------------------------
    def install(self) -> bool:
        """Install handlers; returns False if not on the main thread
        (signal.signal is main-thread-only) — the guard still works via
        :meth:`trigger`."""
        if self._installed:
            return True
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:  # not the main thread
            logger.warning("PreemptionGuard: cannot install signal handlers "
                           "off the main thread; use trigger() instead")
            return False
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- state -------------------------------------------------------------
    def _handler(self, signum, frame) -> None:
        # async-signal-safe: set the flag, log nothing heavy here
        self._event.set()

    def trigger(self) -> None:
        """Request a graceful stop programmatically (tests / schedulers)."""
        self._event.set()

    def reset(self) -> None:
        self._event.clear()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()


def skip_batches(loader: Iterable, n: int) -> Iterable:
    """Yield ``loader`` minus its first ``n`` items (mid-epoch fast-forward).

    The skipped batches are produced by the loader but never uploaded or
    stepped.
    """
    it = iter(loader)
    for _ in range(n):
        try:
            next(it)
        except StopIteration:
            return
    yield from it
