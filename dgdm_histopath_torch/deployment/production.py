"""The inference server's health report (``ProductionHealthChecker`` of the
JAX package's ``deployment/production.py``; its Kubernetes, autoscaler and
orchestrator classes are not ported)."""

from __future__ import annotations

import time
from typing import Any, Dict

from ..utils.dependency_check import check_dependencies
from ..utils.monitoring import GLOBAL_HEALTH


class ProductionHealthChecker:
    """The global checks (host memory, devices) plus ``model_loaded`` (the
    predictor's model has parameters) and ``dependencies`` (every required
    module importable)."""

    def __init__(self, predictor=None):
        self.predictor = predictor

    def check(self) -> Dict[str, Any]:
        report = GLOBAL_HEALTH.check()
        checks = dict(report["checks"])
        if self.predictor is not None:
            try:
                info = self.predictor.get_model_info()
                checks["model_loaded"] = info["num_parameters"] > 0
            except Exception:  # noqa: BLE001 - a broken predictor reports unhealthy
                checks["model_loaded"] = False
        checks["dependencies"] = check_dependencies()["healthy"]
        return {"healthy": all(checks.values()), "checks": checks,
                "timestamp": time.time()}
