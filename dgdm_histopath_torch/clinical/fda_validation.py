"""Clinical validation and a submission dossier (counterpart of the JAX
package's ``clinical/fda_validation.py``).

Cohorts with PHI redacted from their free-text metadata, per-cohort
sensitivity, specificity, PPV, NPV, AUC and a bootstrap CI of the AUC
against acceptance criteria, and a 510(k)-shaped dossier written as JSON.
Research use only: a structured report, not a regulatory filing.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..evaluation.metrics import (
    _roc_auc,
    bootstrap_ci,
    compute_classification_metrics,
    compute_clinical_metrics,
)
from ..utils.logging import get_logger
from ..utils.security import PHIDetector

logger = get_logger("clinical")


@dataclass
class ClinicalCohort:
    cohort_id: str
    description: str = ""
    site: str = ""
    labels: Optional[np.ndarray] = None
    predictions: Optional[np.ndarray] = None
    probabilities: Optional[np.ndarray] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return 0 if self.labels is None else len(self.labels)


class ClinicalDataManager:
    """Cohort registry; PHI in a cohort's string metadata is redacted on
    registration and the redaction audited."""

    def __init__(self):
        self.cohorts: Dict[str, ClinicalCohort] = {}
        self.audit: List[Dict[str, Any]] = []

    def register_cohort(self, cohort: ClinicalCohort) -> None:
        for key, value in cohort.metadata.items():
            if isinstance(value, str) and PHIDetector.contains_phi(value):
                cohort.metadata[key] = PHIDetector.redact(value)
                self.audit.append({"ts": time.time(), "event": "phi_redacted",
                                   "cohort": cohort.cohort_id, "field": key})
        self.cohorts[cohort.cohort_id] = cohort
        self.audit.append({"ts": time.time(), "event": "cohort_registered",
                           "cohort": cohort.cohort_id, "n": cohort.size})

    def add_results(self, cohort_id: str, labels, predictions, probabilities=None) -> None:
        c = self.cohorts[cohort_id]
        c.labels = np.asarray(labels)
        c.predictions = np.asarray(predictions)
        if probabilities is not None:
            c.probabilities = np.asarray(probabilities)

    def summary(self) -> Dict[str, Any]:
        return {cid: {"n": c.size, "site": c.site, "has_results": c.predictions is not None}
                for cid, c in self.cohorts.items()}


# the default acceptance criteria (sensitivity first, a typical CADx bar)
DEFAULT_ACCEPTANCE = {
    "sensitivity": 0.90,
    "specificity": 0.80,
    "auc": 0.90,
}


class ClinicalPerformanceAnalyzer:
    """Each cohort's clinical metrics against the acceptance criteria."""

    def __init__(self, acceptance: Optional[Dict[str, float]] = None):
        self.acceptance = dict(acceptance or DEFAULT_ACCEPTANCE)

    def analyze_cohort(self, cohort: ClinicalCohort) -> Dict[str, Any]:
        if cohort.labels is None or cohort.predictions is None:
            raise ValueError(f"cohort {cohort.cohort_id} has no results")
        report: Dict[str, Any] = {"cohort": cohort.cohort_id, "n": cohort.size,
                                  **compute_clinical_metrics(cohort.labels, cohort.predictions)}
        if cohort.probabilities is not None:
            report["auc"] = compute_classification_metrics(cohort.labels,
                                                           cohort.probabilities)["auc"]
            if cohort.probabilities.ndim == 2 and cohort.probabilities.shape[1] == 2:
                report["auc_ci"] = bootstrap_ci(_roc_auc, cohort.labels,
                                                cohort.probabilities[:, 1], n_bootstrap=500)
        checks = {}
        for metric, minimum in self.acceptance.items():
            value = report.get(metric)
            checks[metric] = value is not None and np.isfinite(value) and value >= minimum
        report["acceptance"] = checks
        report["meets_criteria"] = all(checks.values())
        return report

    def analyze_all(self, manager: ClinicalDataManager) -> Dict[str, Any]:
        reports = {cid: self.analyze_cohort(c) for cid, c in manager.cohorts.items()
                   if c.predictions is not None}
        overall = all(r["meets_criteria"] for r in reports.values()) if reports else False
        return {"cohorts": reports, "all_cohorts_pass": overall}


class FDASubmissionManager:
    """A 510(k)-shaped dossier: the device, its intended use, the performance
    summary, the validation protocol and a risk analysis."""

    def __init__(self, device_name: str = "DGDM Histopathology Analyzer",
                 version: str = "0.1.0"):
        self.device_name = device_name
        self.version = version

    def build_dossier(self, performance: Dict[str, Any], intended_use: str = "",
                      predicate_device: str = "") -> Dict[str, Any]:
        return {
            "submission_type": "510(k) pre-submission draft (RESEARCH USE ONLY)",
            "device": {
                "name": self.device_name,
                "version": self.version,
                "classification": "Class II (anticipated) — CADx software",
                "predicate_device": predicate_device or "TBD",
            },
            "intended_use": intended_use or (
                "Computational analysis of digitized H&E whole-slide images "
                "to assist pathologists; adjunctive use only."),
            "performance_summary": performance,
            "validation_protocol": {
                "study_design": "retrospective multi-site reader-independent",
                "statistical_plan": "AUC with 95% bootstrap CI per cohort; "
                                    "sensitivity/specificity at prespecified "
                                    "operating point",
                "acceptance_criteria": DEFAULT_ACCEPTANCE,
            },
            "risk_analysis": {
                "hazards": [
                    {"hazard": "false negative", "mitigation":
                        "adjunctive-use labeling; sensitivity-first operating point"},
                    {"hazard": "domain shift (scanner/stain)", "mitigation":
                        "stain normalization; per-site validation cohorts"},
                    {"hazard": "adversarial/corrupted input", "mitigation":
                        "input validation; robustness testing (research/"
                        "adversarial_robustness)"},
                ],
            },
            "software_documentation_level": "enhanced",
            "generated_at": time.time(),
        }

    def export(self, dossier: Dict[str, Any], path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dossier, indent=2, default=str))
        logger.info("submission dossier written to %s", path)
        return path
