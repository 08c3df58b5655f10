"""Input validation (counterpart of the JAX package's ``utils/validation.py``):
``InputValidator``'s static checks of scalars, strings, paths and array
shapes, and ``FileValidator``'s slide and graph file checks. Each raises
``ValidationError`` with its context.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from .exceptions import ValidationError

_SAFE_NAME_RE = re.compile(r"^[A-Za-z0-9_\-\.]+$")


class InputValidator:
    """Static validators raising :class:`ValidationError` with context."""

    @staticmethod
    def validate_integer(value: Any, name: str, min_value: Optional[int] = None,
                         max_value: Optional[int] = None) -> int:
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise ValidationError(f"{name} must be an integer", {"got": type(value).__name__})
        v = int(value)
        if min_value is not None and v < min_value:
            raise ValidationError(f"{name} must be >= {min_value}", {"got": v})
        if max_value is not None and v > max_value:
            raise ValidationError(f"{name} must be <= {max_value}", {"got": v})
        return v

    @staticmethod
    def validate_numeric(value: Any, name: str, min_value: Optional[float] = None,
                         max_value: Optional[float] = None, allow_nan: bool = False) -> float:
        if isinstance(value, bool) or not isinstance(value, (int, float, np.integer, np.floating)):
            raise ValidationError(f"{name} must be numeric", {"got": type(value).__name__})
        v = float(value)
        if not allow_nan and (math.isnan(v) or math.isinf(v)):
            raise ValidationError(f"{name} must be finite", {"got": v})
        if min_value is not None and v < min_value:
            raise ValidationError(f"{name} must be >= {min_value}", {"got": v})
        if max_value is not None and v > max_value:
            raise ValidationError(f"{name} must be <= {max_value}", {"got": v})
        return v

    @staticmethod
    def validate_probability(value: Any, name: str) -> float:
        return InputValidator.validate_numeric(value, name, 0.0, 1.0)

    @staticmethod
    def validate_enum(value: Any, name: str, choices: Iterable[Any]) -> Any:
        choices = list(choices)
        if value not in choices:
            raise ValidationError(f"{name} must be one of {choices}", {"got": value})
        return value

    @staticmethod
    def validate_boolean(value: Any, name: str) -> bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false", "1", "0", "yes", "no"):
            return value.lower() in ("true", "1", "yes")
        raise ValidationError(f"{name} must be a boolean", {"got": value})

    @staticmethod
    def validate_string(value: Any, name: str, max_length: int = 4096,
                        pattern: Optional[str] = None, safe_name: bool = False) -> str:
        if not isinstance(value, str):
            raise ValidationError(f"{name} must be a string", {"got": type(value).__name__})
        if len(value) > max_length:
            raise ValidationError(f"{name} exceeds max length {max_length}", {"len": len(value)})
        if safe_name and not _SAFE_NAME_RE.match(value):
            raise ValidationError(f"{name} contains unsafe characters", {"got": value})
        if pattern is not None and not re.match(pattern, value):
            raise ValidationError(f"{name} does not match required pattern", {"pattern": pattern})
        return value

    @staticmethod
    def validate_path(value: Any, name: str, must_exist: bool = False,
                      must_be_file: bool = False, must_be_dir: bool = False,
                      allowed_suffixes: Optional[Sequence[str]] = None) -> Path:
        try:
            p = Path(value)
        except TypeError as exc:
            raise ValidationError(f"{name} is not a valid path", {"got": value}) from exc
        if ".." in p.parts:
            raise ValidationError(f"{name} must not contain parent-directory traversal", {"got": str(p)})
        if must_exist and not p.exists():
            raise ValidationError(f"{name} does not exist", {"path": str(p)})
        if must_be_file and p.exists() and not p.is_file():
            raise ValidationError(f"{name} is not a file", {"path": str(p)})
        if must_be_dir and p.exists() and not p.is_dir():
            raise ValidationError(f"{name} is not a directory", {"path": str(p)})
        if allowed_suffixes is not None and p.suffix.lower() not in [s.lower() for s in allowed_suffixes]:
            raise ValidationError(f"{name} must have suffix in {list(allowed_suffixes)}", {"got": p.suffix})
        return p

    @staticmethod
    def validate_array_shape(arr: Any, name: str, ndim: Optional[int] = None,
                             shape: Optional[Sequence[Optional[int]]] = None) -> Any:
        """Shape check for numpy arrays and tensors; ``None`` in ``shape`` = wildcard."""
        actual = getattr(arr, "shape", None)
        if actual is None:
            raise ValidationError(f"{name} has no shape attribute", {"got": type(arr).__name__})
        if ndim is not None and len(actual) != ndim:
            raise ValidationError(f"{name} must be {ndim}-D", {"shape": tuple(actual)})
        if shape is not None:
            if len(actual) != len(shape):
                raise ValidationError(f"{name} rank mismatch", {"expected": tuple(shape), "shape": tuple(actual)})
            for i, (want, got) in enumerate(zip(shape, actual)):
                if want is not None and want != got:
                    raise ValidationError(
                        f"{name} dim {i} mismatch", {"expected": tuple(shape), "shape": tuple(actual)}
                    )
        return arr

    @staticmethod
    def validate_finite(arr: Any, name: str) -> Any:
        data = np.asarray(arr)
        if not np.all(np.isfinite(data)):
            bad = int(np.size(data) - np.sum(np.isfinite(data)))
            raise ValidationError(f"{name} contains {bad} non-finite values")
        return arr


class FileValidator:
    """File-level checks (size, extension, magic bytes for slide formats)."""

    SLIDE_SUFFIXES = (".svs", ".tif", ".tiff", ".ndpi", ".mrxs", ".wsi")
    GRAPH_SUFFIXES = (".h5", ".hdf5", ".npz")

    @staticmethod
    def validate_slide_file(path: str | Path, max_bytes: int = 50 * 1024**3) -> Path:
        p = InputValidator.validate_path(path, "slide_path", must_exist=True, must_be_file=True,
                                         allowed_suffixes=FileValidator.SLIDE_SUFFIXES)
        size = p.stat().st_size
        if size == 0:
            raise ValidationError("slide file is empty", {"path": str(p)})
        if size > max_bytes:
            raise ValidationError("slide file exceeds size limit", {"path": str(p), "bytes": size})
        return p

    @staticmethod
    def validate_graph_file(path: str | Path) -> Path:
        return InputValidator.validate_path(path, "graph_path", must_exist=True, must_be_file=True,
                                            allowed_suffixes=FileValidator.GRAPH_SUFFIXES)
