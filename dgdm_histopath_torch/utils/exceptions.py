"""Exceptions of the port (counterpart of the JAX package's
``utils/exceptions.py``): a base class with structured context, the domain
errors its entry points raise, ``safe_execute`` and ``ExceptionHandler``."""

from __future__ import annotations

import logging
import traceback
from typing import Any, Callable, Optional, TypeVar

logger = logging.getLogger("dgdm_histopath_torch")

T = TypeVar("T")


class DGDMException(Exception):
    """Base exception. Carries a message plus structured ``context`` details."""

    def __init__(self, message: str, context: Optional[dict] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.message = message
        self.context = dict(context or {})
        self.cause = cause

    def to_dict(self) -> dict:
        return {"type": type(self).__name__, "message": self.message,
                "context": self.context, "cause": repr(self.cause) if self.cause else None}

    def __str__(self) -> str:
        if self.context:
            return f"{self.message} (context: {self.context})"
        return self.message


class ConfigurationError(DGDMException):
    """Invalid or missing configuration."""


class ValidationError(DGDMException):
    """Input validation failure (shapes, ranges, enums, paths)."""


class DataError(DGDMException):
    """Data loading or validation failure."""


class SlideProcessingError(DataError):
    """Whole-slide image processing failure."""


class GraphConstructionError(DataError):
    """Tissue graph construction failure."""


class ModelError(DGDMException):
    """Model construction or forward-pass failure."""


class TrainingError(DGDMException):
    """Training-loop failure."""


class CheckpointError(DGDMException):
    """Checkpoint save/restore failure."""


class InferenceError(DGDMException):
    """Prediction-time failure."""


class ResourceError(DGDMException):
    """Out-of-memory / device / file-handle exhaustion."""


class SecurityError(DGDMException):
    """Security policy violation (a rate limit, path traversal, injection)."""


class QuantumPlannerError(DGDMException):
    """Task planner / scheduler failure (the JAX package's name)."""


def safe_execute(fn: Callable[..., T], *args: Any, default: Optional[T] = None,
                 error_types: tuple = (Exception,), log_errors: bool = True,
                 reraise: bool = False, **kwargs: Any) -> Optional[T]:
    """``fn(*args, **kwargs)``; on one of ``error_types`` log the traceback
    and return ``default`` (or raise again with ``reraise``)."""
    try:
        return fn(*args, **kwargs)
    except error_types as exc:  # noqa: BLE001 - the caller chose the types
        if log_errors:
            logger.error("safe_execute(%s) failed: %s\n%s", getattr(fn, "__name__", fn), exc,
                         traceback.format_exc())
        if reraise:
            raise
        return default


class ExceptionHandler:
    """Collects exceptions with context for later reporting (the last
    ``max_records``)."""

    def __init__(self, max_records: int = 1000):
        self.max_records = max_records
        self.records: list[dict] = []

    def handle(self, exc: BaseException, context: Optional[dict] = None,
               operation: str = "") -> dict:
        record = {"type": type(exc).__name__, "message": str(exc), "operation": operation,
                  "context": dict(context or {}), "traceback": traceback.format_exc()}
        self.records.append(record)
        if len(self.records) > self.max_records:
            self.records = self.records[-self.max_records:]
        logger.error("handled exception in %s: %s", operation or "<unknown>", exc)
        return record

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for r in self.records:
            counts[r["type"]] = counts.get(r["type"], 0) + 1
        return {"total": len(self.records), "by_type": counts}


GLOBAL_EXCEPTION_HANDLER = ExceptionHandler()
