"""Metric alerting (counterpart of the JAX package's ``utils/alerting.py``):
threshold rules over a ``MetricsCollector``'s summary, with a cooldown per
rule and callbacks for each alert fired.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from .logging import get_logger
from .monitoring import GLOBAL_METRICS, MetricsCollector

logger = get_logger("alerting")


class AlertSeverity(Enum):
    INFO = "info"
    WARNING = "warning"
    CRITICAL = "critical"


@dataclass
class AlertRule:
    name: str
    metric: str                     # operation name in the collector
    field: str = "mean_s"           # summary field to test
    threshold: float = 1.0
    comparison: str = "gt"          # gt | lt
    severity: AlertSeverity = AlertSeverity.WARNING
    cooldown_s: float = 60.0
    _last_fired: float = dc_field(default=0.0, repr=False)

    def evaluate(self, summary: Dict[str, Dict[str, float]]) -> Optional[float]:
        stats = summary.get(self.metric)
        if not stats or self.field not in stats:
            return None
        value = stats[self.field]
        breached = value > self.threshold if self.comparison == "gt" else value < self.threshold
        return value if breached else None


@dataclass
class Alert:
    rule: str
    metric: str
    value: float
    threshold: float
    severity: str
    timestamp: float = dc_field(default_factory=time.time)


class AlertManager:
    """Evaluate rules against the metrics collector; fire callbacks."""

    def __init__(self, collector: Optional[MetricsCollector] = None):
        self.collector = collector or GLOBAL_METRICS
        self.rules: Dict[str, AlertRule] = {}
        self.alerts: List[Alert] = []
        self.callbacks: List[Callable[[Alert], None]] = []
        self._lock = threading.Lock()

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self.rules[rule.name] = rule

    def on_alert(self, callback: Callable[[Alert], None]) -> None:
        self.callbacks.append(callback)

    def evaluate(self) -> List[Alert]:
        summary = self.collector.summary()
        fired: List[Alert] = []
        now = time.monotonic()
        with self._lock:
            for rule in self.rules.values():
                value = rule.evaluate(summary)
                if value is None:
                    continue
                if now - rule._last_fired < rule.cooldown_s:
                    continue
                rule._last_fired = now
                alert = Alert(rule.name, rule.metric, value, rule.threshold,
                              rule.severity.value)
                self.alerts.append(alert)
                fired.append(alert)
        for alert in fired:
            logger.log(40 if alert.severity == "critical" else 30,
                       "ALERT %s: %s %s=%.4f (threshold %.4f)", alert.severity,
                       alert.rule, alert.metric, alert.value, alert.threshold)
            for cb in self.callbacks:
                try:
                    cb(alert)
                except Exception as exc:  # noqa: BLE001
                    logger.error("alert callback failed: %s", exc)
        return fired

    def active_summary(self) -> Dict[str, Any]:
        from collections import Counter
        with self._lock:
            return {"total": len(self.alerts),
                    "by_severity": dict(Counter(a.severity for a in self.alerts)),
                    "rules": len(self.rules)}
