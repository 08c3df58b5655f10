"""What this environment has: the port's required and optional modules, and
torch's CUDA build and devices (counterpart of the JAX package's
``utils/dependency_check.py``, with the port's own lists)."""

from __future__ import annotations

import importlib.util
import platform
import sys
from typing import Dict, List

REQUIRED = ["torch", "numpy"]
OPTIONAL = {
    "yaml": "YAML configs and the config snapshot",
    "h5py": "HDF5 graph files",
    "PIL": "the PIL slide backend",
    "openslide": "native .svs/.ndpi decoding",
    "scipy": "connected-component labeling of the tissue mask",
    "matplotlib": "visualization (dgdm-predict --save-heatmaps)",
    "plotly": "plotly Figure objects of the interactive specs",
}


def probe(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except (ImportError, ValueError):
        return False


def check_dependencies() -> Dict[str, object]:
    """The environment report: Python, platform, each module's presence and,
    when torch imports, its version, CUDA build and devices."""
    required = {m: probe(m) for m in REQUIRED}
    optional = {m: {"available": probe(m), "enables": desc}
                for m, desc in OPTIONAL.items()}
    missing_required = [m for m, ok in required.items() if not ok]
    report: Dict[str, object] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "required": required,
        "optional": optional,
        "missing_required": missing_required,
        "healthy": not missing_required,
    }
    if required.get("torch"):
        try:
            import torch
            count = torch.cuda.device_count()
            report["torch"] = {
                "version": torch.__version__,
                "cuda": torch.version.cuda,
                "device_count": count,
                "devices": [torch.cuda.get_device_name(i) for i in range(count)],
            }
        except Exception as exc:  # noqa: BLE001 - the report names the failure
            report["torch"] = {"error": str(exc)}
    return report


def degraded_features() -> List[str]:
    """Which capabilities are unavailable in this environment."""
    return [f"{m}: {desc}" for m, desc in OPTIONAL.items() if not probe(m)]


def assert_healthy() -> None:
    report = check_dependencies()
    if not report["healthy"]:
        from .exceptions import ConfigurationError
        raise ConfigurationError("missing required dependencies",
                                 {"missing": report["missing_required"]})
