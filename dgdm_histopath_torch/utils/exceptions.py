"""Exceptions of the port: a base class with structured context and the
domain errors its entry points raise."""

from __future__ import annotations

from typing import Optional


class DGDMException(Exception):
    """Base exception. Carries a message plus structured ``context`` details."""

    def __init__(self, message: str, context: Optional[dict] = None):
        super().__init__(message)
        self.message = message
        self.context = dict(context or {})

    def __str__(self) -> str:
        if self.context:
            return f"{self.message} (context: {self.context})"
        return self.message


class ConfigurationError(DGDMException):
    """Invalid or missing configuration."""


class ValidationError(DGDMException):
    """Input validation failure (shapes, ranges, enums, paths)."""


class CheckpointError(DGDMException):
    """Checkpoint save/restore failure."""


class InferenceError(DGDMException):
    """Prediction-time failure."""


class SecurityError(DGDMException):
    """Security policy violation (a rate limit, path traversal, injection)."""


class DataError(DGDMException):
    """Data loading or validation failure."""


class SlideProcessingError(DataError):
    """Whole-slide image processing failure."""


class GraphConstructionError(DataError):
    """Tissue graph construction failure."""
