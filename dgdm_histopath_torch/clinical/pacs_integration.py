"""PACS/EHR integration: DICOM metadata and its de-identification,
FHIR-shaped observations, and the route from a study to the EHR
(counterpart of the JAX package's ``clinical/pacs_integration.py``).

``PACSEHRIntegrationManager.process_study`` anonymizes the study's DICOM
attributes (PHI tags replaced by salted SHA-256 pseudonyms, the same as
the JAX package's bit for bit; PHI in other text redacted), refuses the
study if PHI survives, runs the predictor's ``predict_slide`` (on the card,
the featurizer, the kNN and the DGDM forward with its gather kernels) and
sends the observation through the connector's transport, a callable: an
HTTP client in a deployment, an in-memory outbox by default.
"""

from __future__ import annotations

import hashlib
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import get_logger
from ..utils.security import PHIDetector

logger = get_logger("clinical")

# DICOM tags removed or replaced for de-identification (a PS3.15 E.1 subset)
PHI_DICOM_TAGS = [
    "PatientName", "PatientID", "PatientBirthDate", "PatientAddress",
    "PatientTelephoneNumbers", "ReferringPhysicianName", "InstitutionName",
    "InstitutionAddress", "OperatorsName", "AccessionNumber",
]


@dataclass
class DICOMMetadata:
    sop_instance_uid: str
    study_instance_uid: str
    series_instance_uid: str
    modality: str = "SM"              # slide microscopy
    attributes: Dict[str, Any] = field(default_factory=dict)


class DICOMHandler:
    """WSI-DICOM metadata and de-identification with a per-site salt."""

    def __init__(self, site_salt: str = "dgdm"):
        self.site_salt = site_salt

    def _pseudonym(self, value: str) -> str:
        return hashlib.sha256(f"{self.site_salt}:{value}".encode()).hexdigest()[:16]

    def extract_metadata(self, attributes: Dict[str, Any]) -> DICOMMetadata:
        return DICOMMetadata(
            sop_instance_uid=str(attributes.get("SOPInstanceUID", uuid.uuid4())),
            study_instance_uid=str(attributes.get("StudyInstanceUID", uuid.uuid4())),
            series_instance_uid=str(attributes.get("SeriesInstanceUID", uuid.uuid4())),
            modality=str(attributes.get("Modality", "SM")),
            attributes=dict(attributes))

    def anonymize(self, meta: DICOMMetadata) -> DICOMMetadata:
        """PHI tags -> stable pseudonyms; PHI in any other string redacted."""
        attrs = dict(meta.attributes)
        for tag in PHI_DICOM_TAGS:
            if tag in attrs and attrs[tag]:
                attrs[tag] = self._pseudonym(str(attrs[tag]))
        for tag, value in list(attrs.items()):
            if isinstance(value, str) and PHIDetector.contains_phi(value):
                attrs[tag] = PHIDetector.redact(value)
        return DICOMMetadata(meta.sop_instance_uid, meta.study_instance_uid,
                             meta.series_instance_uid, meta.modality, attrs)

    @staticmethod
    def verify_anonymized(meta: DICOMMetadata) -> bool:
        return not any(isinstance(v, str) and PHIDetector.contains_phi(v)
                       for v in meta.attributes.values())


class EHRConnector:
    """FHIR-shaped diagnostic observations, sent by ``transport(resource)
    -> response``; without one, each is kept in ``outbox``."""

    def __init__(self, transport: Optional[Callable[[Dict], Dict]] = None):
        self.transport = transport or self._record
        self.outbox: List[Dict] = []

    def _record(self, resource: Dict) -> Dict:
        self.outbox.append(resource)
        return {"status": "recorded", "id": resource["id"]}

    def build_observation(self, prediction: Dict[str, Any], subject_ref: str,
                          class_names=None) -> Dict[str, Any]:
        cls = prediction.get("predicted_class")
        display = class_names[cls] if class_names and cls is not None else f"class {cls}"
        return {
            "resourceType": "Observation",
            "id": str(uuid.uuid4()),
            "status": "preliminary",
            "category": [{"coding": [{"system":
                "http://terminology.hl7.org/CodeSystem/observation-category",
                "code": "imaging"}]}],
            "code": {"text": "Computational histopathology classification"},
            "subject": {"reference": subject_ref},
            "valueCodeableConcept": {"text": display},
            "component": [
                {"code": {"text": "confidence"},
                 "valueQuantity": {"value": float(prediction.get("confidence", 0.0))}},
                {"code": {"text": "entropy"},
                 "valueQuantity": {"value": float(
                     prediction.get("uncertainty", {}).get("entropy", 0.0))}},
            ],
            # the JAX package's device string, so that an EHR sees one device
            "device": {"display": "DGDM Histopath TPU (research use only)"},
            "issued": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }

    def send_observation(self, observation: Dict[str, Any]) -> Dict[str, Any]:
        return self.transport(observation)


class PACSEHRIntegrationManager:
    """A study in -> de-identified metadata -> ``predictor.predict_slide`` ->
    an observation out to the EHR; each study's record kept in
    ``processed``."""

    def __init__(self, predictor, dicom_handler: Optional[DICOMHandler] = None,
                 ehr: Optional[EHRConnector] = None, class_names=None):
        self.predictor = predictor
        self.dicom = dicom_handler or DICOMHandler()
        self.ehr = ehr or EHRConnector()
        self.class_names = class_names
        self.processed: List[Dict[str, Any]] = []

    def process_study(self, slide_source, dicom_attributes: Dict[str, Any]) -> Dict[str, Any]:
        meta = self.dicom.anonymize(self.dicom.extract_metadata(dicom_attributes))
        if not self.dicom.verify_anonymized(meta):
            raise ValueError("anonymization failed PHI verification")
        prediction = self.predictor.predict_slide(slide_source, slide_id=meta.sop_instance_uid)
        observation = self.ehr.build_observation(
            prediction, subject_ref=f"Patient/{meta.attributes.get('PatientID', 'anon')}",
            class_names=self.class_names)
        response = self.ehr.send_observation(observation)
        record = {"sop_instance_uid": meta.sop_instance_uid,
                  "prediction": prediction.get("predicted_class"),
                  "confidence": prediction.get("confidence"),
                  "ehr_status": response.get("status")}
        self.processed.append(record)
        return record
