"""``ResilientTrainer``: retries, skips, step-frequency checkpoints and
allocator cleanup around ``DGDMTrainer.training_step`` (counterpart of the
JAX package's ``utils/resilient_training.py``).

A retried step replays exactly when the failure came before the update:
the step seeds its draws from ``(seed, step)`` and counts ``step`` only
after the optimizer ran. A failure inside the optimizer's update leaves the
parameters it already wrote (the JAX step is functional and cannot), so a
retry then starts from them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional

from .logging import get_logger
from .optimization import clear_device_caches
from .resilience import RetryPolicy

logger = get_logger("resilient_training")


class ResilientTrainer:
    """Fault-tolerant wrapper over a ``DGDMTrainer``'s step API.

    A failed step is tried ``max_batch_retries`` more times (the CUDA
    allocator's cache is cleared before each retry); a batch that still
    fails is skipped (``skip_failed_batches``) or raised. Every
    ``checkpoint_every_steps`` successful steps ``checkpoint_manager.save``
    receives ``trainer.state_dict()`` with the step's loss; every
    ``cleanup_every_steps`` the allocator's cache is cleared."""

    def __init__(self, trainer, checkpoint_manager=None, checkpoint_every_steps: int = 500,
                 cleanup_every_steps: int = 1000, max_batch_retries: int = 2,
                 skip_failed_batches: bool = True):
        self.trainer = trainer
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_every_steps = checkpoint_every_steps
        self.cleanup_every_steps = cleanup_every_steps
        self.retry = RetryPolicy(max_attempts=max_batch_retries + 1, base_delay=0.5)
        self.skip_failed_batches = skip_failed_batches
        self.stats = {"steps": 0, "errors_recovered": 0, "batches_skipped": 0,
                      "checkpoints_saved": 0}
        self.best_loss = float("inf")
        self.best_step: Optional[int] = None

    def training_step(self, batch, epoch: Optional[int] = None) -> Optional[Dict[str, float]]:
        """One step with retry and skip semantics; None for a skipped batch."""
        attempts = [0]

        def attempt():
            if attempts[0] > 0:
                self.stats["errors_recovered"] += 1
                clear_device_caches()
            attempts[0] += 1
            return self.trainer.training_step(batch, epoch)

        try:
            metrics = self.retry.execute(attempt)
        except Exception as exc:  # noqa: BLE001 - skipping is the caller's choice
            if not self.skip_failed_batches:
                raise
            logger.error("batch skipped after retries: %s", exc)
            self.stats["batches_skipped"] += 1
            return None

        self.stats["steps"] += 1
        step = self.stats["steps"]
        loss = metrics.get("loss", float("inf"))
        if loss < self.best_loss:
            self.best_loss = loss
            self.best_step = step
        if self.checkpoint_manager is not None and step % self.checkpoint_every_steps == 0:
            self.checkpoint_manager.save(self.trainer.state_dict(), step=step, metric=loss)
            self.stats["checkpoints_saved"] += 1
        if step % self.cleanup_every_steps == 0:
            clear_device_caches()
        return metrics

    def train_epoch(self, loader: Iterable, epoch: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            m = self.training_step(batch, epoch)
            if m is not None:
                losses.append(m.get("loss"))
        return {"epoch": epoch,
                "mean_loss": sum(losses) / len(losses) if losses else float("nan"),
                "batches": len(losses), "duration_s": time.perf_counter() - t0, **self.stats}

    def recover_from_checkpoint(self) -> bool:
        """Load the last saved checkpoint into the wrapped trainer; False
        when there is none."""
        if self.checkpoint_manager is None or self.checkpoint_manager.last_step is None:
            return False
        self.trainer.load_state_dict(self.checkpoint_manager.restore())
        logger.info("recovered from checkpoint step=%s", self.checkpoint_manager.last_step)
        return True
