"""Experiment logging: scalar metrics to ``metrics.csv`` and ``metrics.jsonl``
always, and to TensorBoard or Weights & Biases where they import
(counterpart of the JAX package's ``training/experiment_logging.py``).

Callers hand in host floats: the trainer accumulates its metrics on the
device and syncs once per epoch, so logging adds no device round trip.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

from ..utils.logging import get_logger

logger = get_logger("training.logging")


def _tensorboard_writer(log_dir: Path):
    """TensorBoard event writer, or None (with a warning) where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=str(log_dir))
    except Exception as exc:  # noqa: BLE001 - any import-time failure of the backend
        logger.warning("tensorboard unavailable (%s); falling back to csv", exc)
        return None


def _wandb_run(log_dir: Path, run_name: Optional[str], hparams: Dict[str, Any]):
    """A wandb run, or None (with a warning) where it does not start."""
    try:
        import wandb
        return wandb.init(project="dgdm-histopath", name=run_name, dir=str(log_dir),
                          config=hparams)
    except Exception as exc:  # noqa: BLE001 - any failure of the backend
        logger.warning("wandb unavailable (%s); falling back to csv", exc)
        return None


class TrainLogger:
    """Scalar experiment logger.

    Always writes ``metrics.csv`` and ``metrics.jsonl`` under ``log_dir``;
    also streams to TensorBoard event files (``logger_type='tensorboard'``)
    or Weights & Biases (``'wandb'``) where the backend imports. ``'csv'`` and
    ``'none'`` add no backend.
    """

    def __init__(self, log_dir: str | Path, logger_type: str = "tensorboard",
                 run_name: Optional[str] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.logger_type = logger_type
        self.run_name = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self._rows: list[Dict[str, Any]] = []
        self._csv_path = self.log_dir / "metrics.csv"
        self._jsonl_path = self.log_dir / "metrics.jsonl"
        self._hparams: Dict[str, Any] = {}
        self._tb = None
        self._wandb = None
        if logger_type == "tensorboard":
            self._tb = _tensorboard_writer(self.log_dir / "tb")
        elif logger_type == "wandb":
            self._wandb = _wandb_run(self.log_dir, self.run_name, {})
        elif logger_type not in ("csv", "none"):
            raise ValueError(f"unknown logger_type {logger_type!r}")
        self._jsonl = open(self._jsonl_path, "a", encoding="utf-8")

    def log_hparams(self, hparams: Mapping[str, Any]) -> None:
        self._hparams.update(hparams)
        (self.log_dir / "hparams.json").write_text(
            json.dumps(self._hparams, indent=2, default=str))
        if self._wandb is not None:
            self._wandb.config.update(dict(hparams), allow_val_change=True)

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        row: Dict[str, Any] = {"step": int(step), "time": time.time(), **scalars}
        self._rows.append(row)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        self._rewrite_csv()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(dict(scalars), step=step)

    def _rewrite_csv(self) -> None:
        # the union of keys over the rows, so that a metric that appears late
        # (val_loss after the first validation) still gets its column
        keys: list[str] = ["step", "time"]
        for row in self._rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        with open(self._csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(self._rows)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def make_logger(logging_cfg, log_dir: str | Path,
                run_name: Optional[str] = None) -> TrainLogger:
    """A TrainLogger from ``utils.config.LoggingConfig`` (its ``logger_type``)."""
    return TrainLogger(log_dir, logger_type=logging_cfg.logger_type, run_name=run_name)
