"""Autonomous test runner: a self-contained smoke and integration harness
that runs without pytest and writes a scored report (counterpart of the JAX
package's ``testing/autonomous.py``)."""

from __future__ import annotations

import functools
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .quality_gates import GATES, QualityGateRunner

logger = get_logger("testing")


class DGDMTestSuite:
    """Named test registry, seeded with the quality gates on ``device``
    (``None``: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.tests: Dict[str, Callable[[], None]] = {
            f"gate:{name}": functools.partial(fn, self.device) for name, fn in GATES.items()}

    def register(self, name: str, fn: Callable[[], None]) -> None:
        self.tests[name] = fn

    def run(self, pattern: Optional[str] = None) -> List[Dict[str, Any]]:
        results = []
        for name, fn in self.tests.items():
            if pattern and pattern not in name:
                continue
            t0 = time.perf_counter()
            try:
                fn()
                status, error = "passed", None
            except Exception as exc:  # noqa: BLE001 - a failed test is a result
                status, error = "failed", f"{exc}"
                logger.error("test %s failed: %s\n%s", name, exc, traceback.format_exc())
            results.append({"name": name, "status": status,
                            "duration_s": round(time.perf_counter() - t0, 3), "error": error})
        return results


class AutonomousTestRunner:
    """End-to-end self-test: the suite, the gates at ``level`` and a report
    (``autonomous_report.json`` under ``output_dir`` where given)."""

    def __init__(self, output_dir: Optional[str | Path] = None, level: str = "development",
                 device=None):
        self.suite = DGDMTestSuite(device)
        self.level = level
        self.output_dir = Path(output_dir) if output_dir else None

    def run(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        results = self.suite.run()
        passed = sum(1 for r in results if r["status"] == "passed")
        gate_report = QualityGateRunner(self.level, device=self.suite.device).run()
        report = {
            "timestamp": time.time(),
            "duration_s": round(time.perf_counter() - t0, 2),
            "tests": {"total": len(results), "passed": passed,
                      "failed": len(results) - passed, "results": results},
            "quality_gates": gate_report,
            "overall_pass": passed == len(results) and gate_report["passed"],
        }
        if self.output_dir is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            (self.output_dir / "autonomous_report.json").write_text(json.dumps(report, indent=2))
        return report
