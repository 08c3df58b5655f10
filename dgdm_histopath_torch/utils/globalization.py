"""Internationalization and regulatory-compliance helpers (host only; the
port's own copy of the JAX package's ``utils/globalization.py``):
``InternationalizationManager`` (UI and clinical strings in six languages),
the GDPR / HIPAA / CCPA / PIPEDA / LGPD / APPI regimes and their per-region
requirements.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from .logging import get_logger

logger = get_logger("globalization")


class ComplianceRegime(Enum):
    GDPR = "gdpr"        # EU
    HIPAA = "hipaa"      # US healthcare
    CCPA = "ccpa"        # California
    PIPEDA = "pipeda"    # Canada
    LGPD = "lgpd"        # Brazil
    APPI = "appi"        # Japan


REGION_REGIMES: Dict[str, List[ComplianceRegime]] = {
    "eu": [ComplianceRegime.GDPR],
    "us": [ComplianceRegime.HIPAA, ComplianceRegime.CCPA],
    "ca": [ComplianceRegime.PIPEDA],
    "br": [ComplianceRegime.LGPD],
    "jp": [ComplianceRegime.APPI],
}

COMPLIANCE_REQUIREMENTS: Dict[ComplianceRegime, Dict[str, bool]] = {
    ComplianceRegime.GDPR: {
        "explicit_consent": True, "right_to_erasure": True,
        "data_portability": True, "breach_notification_72h": True,
        "data_minimization": True, "phi_encryption": True,
    },
    ComplianceRegime.HIPAA: {
        "phi_encryption": True, "audit_logging": True,
        "access_controls": True, "breach_notification_60d": True,
        "business_associate_agreements": True,
    },
    ComplianceRegime.CCPA: {
        "opt_out": True, "disclosure_on_request": True, "no_sale_of_phi": True,
    },
    ComplianceRegime.PIPEDA: {"consent": True, "safeguards": True},
    ComplianceRegime.LGPD: {"legal_basis": True, "dpo_required": True},
    ComplianceRegime.APPI: {"purpose_limitation": True, "cross_border_consent": True},
}

# UI + clinical strings in 6 languages (en/es/fr/de/ja/zh)
_TRANSLATIONS: Dict[str, Dict[str, str]] = {
    "en": {
        "prediction": "Prediction", "confidence": "Confidence",
        "tumor": "Tumor", "benign": "Benign", "malignant": "Malignant",
        "biopsy": "Biopsy", "metastasis": "Metastasis",
        "attention_map": "Attention map", "uncertainty": "Uncertainty",
        "slide_processed": "Slide processed", "error": "Error",
    },
    "es": {
        "prediction": "Predicción", "confidence": "Confianza",
        "tumor": "Tumor", "benign": "Benigno", "malignant": "Maligno",
        "biopsy": "Biopsia", "metastasis": "Metástasis",
        "attention_map": "Mapa de atención", "uncertainty": "Incertidumbre",
        "slide_processed": "Portaobjetos procesado", "error": "Error",
    },
    "fr": {
        "prediction": "Prédiction", "confidence": "Confiance",
        "tumor": "Tumeur", "benign": "Bénin", "malignant": "Malin",
        "biopsy": "Biopsie", "metastasis": "Métastase",
        "attention_map": "Carte d'attention", "uncertainty": "Incertitude",
        "slide_processed": "Lame traitée", "error": "Erreur",
    },
    "de": {
        "prediction": "Vorhersage", "confidence": "Konfidenz",
        "tumor": "Tumor", "benign": "Gutartig", "malignant": "Bösartig",
        "biopsy": "Biopsie", "metastasis": "Metastase",
        "attention_map": "Aufmerksamkeitskarte", "uncertainty": "Unsicherheit",
        "slide_processed": "Schnitt verarbeitet", "error": "Fehler",
    },
    "ja": {
        "prediction": "予測", "confidence": "信頼度",
        "tumor": "腫瘍", "benign": "良性", "malignant": "悪性",
        "biopsy": "生検", "metastasis": "転移",
        "attention_map": "注意マップ", "uncertainty": "不確実性",
        "slide_processed": "スライド処理済み", "error": "エラー",
    },
    "zh": {
        "prediction": "预测", "confidence": "置信度",
        "tumor": "肿瘤", "benign": "良性", "malignant": "恶性",
        "biopsy": "活检", "metastasis": "转移",
        "attention_map": "注意力图", "uncertainty": "不确定性",
        "slide_processed": "切片已处理", "error": "错误",
    },
}


class InternationalizationManager:
    """Language + region manager."""

    def __init__(self, language: str = "en", region: str = "us"):
        if language not in _TRANSLATIONS:
            raise ValueError(f"unsupported language {language!r}; "
                             f"available: {sorted(_TRANSLATIONS)}")
        self.language = language
        self.region = region.lower()

    @property
    def supported_languages(self) -> List[str]:
        return sorted(_TRANSLATIONS)

    def translate(self, key: str, language: Optional[str] = None) -> str:
        lang = language or self.language
        table = _TRANSLATIONS.get(lang, _TRANSLATIONS["en"])
        return table.get(key, _TRANSLATIONS["en"].get(key, key))

    t = translate  # short alias

    def translate_report(self, report: Dict[str, object]) -> Dict[str, object]:
        """Translate the keys of a prediction report for display."""
        return {self.translate(k): v for k, v in report.items()}

    # ------------------------------------------------------------------
    def active_regimes(self) -> List[ComplianceRegime]:
        return REGION_REGIMES.get(self.region, [])

    def compliance_requirements(self) -> Dict[str, bool]:
        merged: Dict[str, bool] = {}
        for regime in self.active_regimes():
            merged.update(COMPLIANCE_REQUIREMENTS[regime])
        return merged

    def check_compliance(self, implemented: Dict[str, bool]) -> Dict[str, object]:
        """Compare implemented controls against regional requirements."""
        required = self.compliance_requirements()
        missing = [k for k, v in required.items()
                   if v and not implemented.get(k, False)]
        return {"region": self.region,
                "regimes": [r.value for r in self.active_regimes()],
                "compliant": not missing, "missing_controls": missing}
