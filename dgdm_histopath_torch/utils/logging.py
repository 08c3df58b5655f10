"""Logging setup (counterpart of the JAX package's ``utils/logging.py``).

``setup_logging`` configures the package's root logger: a console handler,
an optional rotating JSON file, and a filter that redacts secret-looking
substrings; ``get_logger`` returns loggers under that root;
``log_execution_time`` logs the wall time of each call of a function.
"""

from __future__ import annotations

import functools
import json
import logging
import logging.handlers
import re
import sys
import time
from pathlib import Path
from typing import Callable, Optional

_ROOT_NAME = "dgdm_histopath_torch"

_SENSITIVE_PATTERNS = [
    re.compile(r"(password|passwd|secret|token|api[_-]?key)\s*[=:]\s*\S+", re.IGNORECASE),
    re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),  # SSN-shaped
]


class SecurityAuditFilter(logging.Filter):
    """Redacts sensitive-looking substrings from log records."""

    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        redacted = msg
        for pat in _SENSITIVE_PATTERNS:
            redacted = pat.sub("[REDACTED]", redacted)
        if redacted != msg:
            record.msg = redacted
            record.args = ()
        return True


class EnhancedFormatter(logging.Formatter):
    """Formatter with optional JSON output for machine ingestion."""

    def __init__(self, json_format: bool = False):
        super().__init__(fmt="%(asctime)s | %(levelname)-7s | %(name)s | %(message)s",
                         datefmt="%Y-%m-%d %H:%M:%S")
        self.json_format = json_format

    def format(self, record: logging.LogRecord) -> str:
        if not self.json_format:
            return super().format(record)
        payload = {"ts": self.formatTime(record, self.datefmt), "level": record.levelname,
                   "logger": record.name, "message": record.getMessage()}
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(level: str | int = "INFO", log_file: Optional[str | Path] = None,
                  json_format: bool = False, enable_security_filter: bool = True,
                  max_bytes: int = 10 * 1024 * 1024, backup_count: int = 3) -> logging.Logger:
    """Configure the package's root logger. Idempotent."""
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(level if isinstance(level, int)
                  else getattr(logging, str(level).upper(), logging.INFO))
    root.handlers.clear()
    root.propagate = False

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(EnhancedFormatter(json_format=json_format))
    if enable_security_filter:
        console.addFilter(SecurityAuditFilter())
    root.addHandler(console)

    if log_file is not None:
        path = Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(path, maxBytes=max_bytes,
                                                  backupCount=backup_count)
        fh.setFormatter(EnhancedFormatter(json_format=True))
        if enable_security_filter:
            fh.addFilter(SecurityAuditFilter())
        root.addHandler(fh)
    return root


def get_logger(name: str = "") -> logging.Logger:
    """Namespaced logger under the package's root."""
    if not name or name == _ROOT_NAME:
        return logging.getLogger(_ROOT_NAME)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")


def log_execution_time(fn: Callable) -> Callable:
    """Decorator: log the wall-clock time of each call at DEBUG level."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        logger = get_logger(fn.__module__)
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            logger.debug("%s took %.4fs", fn.__qualname__, time.perf_counter() - start)

    return wrapper
