"""The clinical layer (counterpart of the JAX package's ``clinical/``):
validation cohorts and a submission dossier, DICOM de-identification and
the PACS -> predict_slide -> EHR route."""

from .fda_validation import (
    DEFAULT_ACCEPTANCE,
    ClinicalCohort,
    ClinicalDataManager,
    ClinicalPerformanceAnalyzer,
    FDASubmissionManager,
)
from .pacs_integration import (
    PHI_DICOM_TAGS,
    DICOMHandler,
    DICOMMetadata,
    EHRConnector,
    PACSEHRIntegrationManager,
)

__all__ = [
    "ClinicalCohort", "ClinicalDataManager", "ClinicalPerformanceAnalyzer",
    "FDASubmissionManager", "DEFAULT_ACCEPTANCE",
    "DICOMHandler", "DICOMMetadata", "EHRConnector",
    "PACSEHRIntegrationManager", "PHI_DICOM_TAGS",
]
