"""The port's clinical layer (``clinical/``) against the JAX package's, on
the CPU: DICOM pseudonyms bit for bit, observations equal but for their
``id`` and ``issued``, the analyzer's metrics and bootstrap CIs equal, and
the slice as a whole: ``PACSEHRIntegrationManager.process_study`` on a small
deflate-tiled TIFF through a 2-layer f32 DGDM with the JAX model's weights
and the ``"stats"`` featurizer gives JAX's class, with the confidence within
1e-4 (the features differ through Macenko by up to 1e-4 of their scale,
``tests/test_torch_slide.py``). The JAX side reads with
``DGDM_NATIVE_IO=0``, so that no port test starts its native build.
"""

import json
import os

import jax
import numpy as np
import pytest

from conftest import make_synthetic_graph
from dgdm_histopath_tpu import clinical as jcl
from dgdm_histopath_tpu.evaluation import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_torch import clinical as tcl
from dgdm_histopath_torch.convert import encoder_params_from_flax, load_state
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.utils.security import PHIDetector
from test_torch_slide import _write_slides

# a narrow DGDM of 2 graph layers over the 14-d "stats" features
MODEL = dict(node_features=14, hidden_dims=(32, 16), num_diffusion_steps=4, attention_heads=4,
             graph_layers=2, num_classes=3, use_hierarchical=False, compute_dtype="float32")

ATTRS = {"SOPInstanceUID": "1.2.840.1", "StudyInstanceUID": "1.2.840.2",
         "SeriesInstanceUID": "1.2.840.3", "Modality": "SM", "PatientName": "DOE^JANE",
         "PatientID": "MRN 1234567", "PatientBirthDate": "19700101",
         "AccessionNumber": "A-77", "InstitutionName": "General Hospital",
         "StudyDescription": "call 555-123-4567 or jane@example.com",
         "SeriesDescription": "H&E 20x"}


@pytest.mark.parametrize("salt", ["dgdm", "site-42"])
def test_pseudonyms_and_anonymization_equal_jax(salt):
    ours = tcl.DICOMHandler(salt)
    theirs = jcl.DICOMHandler(salt)
    meta, jmeta = ours.extract_metadata(ATTRS), theirs.extract_metadata(ATTRS)
    anon, janon = ours.anonymize(meta), theirs.anonymize(jmeta)
    assert anon.attributes == janon.attributes
    assert (anon.sop_instance_uid, anon.modality) == ("1.2.840.1", "SM")
    for tag in tcl.PHI_DICOM_TAGS:
        if tag in ATTRS:
            assert anon.attributes[tag] == theirs._pseudonym(ATTRS[tag]) != ATTRS[tag]
    assert ours.verify_anonymized(anon) and not ours.verify_anonymized(meta)
    assert tcl.PHI_DICOM_TAGS == jcl.PHI_DICOM_TAGS


def test_observation_equals_jax_but_for_id_and_issued():
    pred = {"predicted_class": 1, "confidence": 0.87, "uncertainty": {"entropy": 0.3}}
    obs = tcl.EHRConnector().build_observation(pred, "Patient/x", ["benign", "tumor"])
    jobs = jcl.EHRConnector().build_observation(pred, "Patient/x", ["benign", "tumor"])
    assert obs["id"] != jobs["id"]
    assert {k: v for k, v in obs.items() if k not in ("id", "issued")} == \
        {k: v for k, v in jobs.items() if k not in ("id", "issued")}
    sent = []
    ehr = tcl.EHRConnector(transport=lambda r: sent.append(r) or {"status": "sent"})
    assert ehr.send_observation(obs) == {"status": "sent"} and sent == [obs]
    rec = tcl.EHRConnector()
    assert rec.send_observation(obs) == {"status": "recorded", "id": obs["id"]}
    assert rec.outbox == [obs]


def _cohorts(mod, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 2, 120)
    probs = np.clip(labels * 0.6 + rs.rand(120) * 0.4, 0, 1)
    mgr = mod.ClinicalDataManager()
    mgr.register_cohort(mod.ClinicalCohort("c1", site="A",
                                           metadata={"note": "patient SSN 123-45-6789"}))
    mgr.register_cohort(mod.ClinicalCohort("c2", site="B"))
    mgr.register_cohort(mod.ClinicalCohort("c3", site="C"))     # no results
    mgr.add_results("c1", labels, (probs > 0.5).astype(int), np.stack([1 - probs, probs], 1))
    mgr.add_results("c2", labels[:60], (probs[:60] > 0.7).astype(int))
    return mgr


@pytest.mark.parametrize("seed", [0, 3])
def test_analyzer_reports_equal_jax(seed):
    ours, theirs = _cohorts(tcl, seed), _cohorts(jcl, seed)
    assert ours.summary() == theirs.summary()
    assert ours.cohorts["c1"].metadata == theirs.cohorts["c1"].metadata
    assert "123-45-6789" not in ours.cohorts["c1"].metadata["note"]
    assert [e["event"] for e in ours.audit] == [e["event"] for e in theirs.audit]
    report = tcl.ClinicalPerformanceAnalyzer().analyze_all(ours)
    jreport = jcl.ClinicalPerformanceAnalyzer().analyze_all(theirs)
    assert json.dumps(report, sort_keys=True, default=str) == \
        json.dumps(jreport, sort_keys=True, default=str)
    assert "auc_ci" in report["cohorts"]["c1"] and "c3" not in report["cohorts"]
    with pytest.raises(ValueError, match="no results"):
        tcl.ClinicalPerformanceAnalyzer().analyze_cohort(ours.cohorts["c3"])


def test_dossier_and_export_equal_jax(tmp_path):
    perf = {"auc": 0.95, "sensitivity": 0.91}
    dossier = tcl.FDASubmissionManager().build_dossier(perf, predicate_device="K000000")
    jdossier = jcl.FDASubmissionManager().build_dossier(perf, predicate_device="K000000")
    assert {k: v for k, v in dossier.items() if k != "generated_at"} == \
        {k: v for k, v in jdossier.items() if k != "generated_at"}
    path = tcl.FDASubmissionManager().export(dossier, tmp_path / "sub" / "dossier.json")
    text = path.read_text()
    assert json.loads(text)["performance_summary"] == perf and not PHIDetector.contains_phi(text)
    assert tcl.DEFAULT_ACCEPTANCE == jcl.DEFAULT_ACCEPTANCE


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """process_study of two slides in both packages (2-layer f32 DGDM)."""
    paths = _write_slides(tmp_path_factory.mktemp("studies"), (21, 22))
    jm = JaxDGDM(**MODEL)
    g = jax.tree_util.tree_map(lambda a: a[None] if hasattr(a, "ndim") else a,
                               make_synthetic_graph(n_nodes=32, n_real=20, feat_dim=14))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "diffusion", "masking"))}
    params = jax.jit(lambda gg: jm.init(rngs, gg, mode="pretrain", deterministic=True))(g)
    tm = DGDMModel(**MODEL)
    load_state(tm, encoder_params_from_flax(params))
    kw = dict(patch_size=32, max_patches=30, tissue_threshold=0.3, feature_extractor="stats",
              stain_normalize=True, node_buckets=[32, 64], decode_workers=1)
    port = tcl.PACSEHRIntegrationManager(
        DGDMPredictor(model=tm, device="cpu", **kw),
        class_names=["a", "b", "c"])
    ours = [port.process_study(p, dict(ATTRS, SOPInstanceUID=f"1.2.{i}"))
            for i, p in enumerate(paths)]
    old = os.environ.get("DGDM_NATIVE_IO")
    os.environ["DGDM_NATIVE_IO"] = "0"
    try:
        ref = jcl.PACSEHRIntegrationManager(JaxPredictor(model=jm, params=params, **kw),
                                            class_names=["a", "b", "c"])
        theirs = [ref.process_study(p, dict(ATTRS, SOPInstanceUID=f"1.2.{i}"))
                  for i, p in enumerate(paths)]
    finally:
        if old is None:
            del os.environ["DGDM_NATIVE_IO"]
        else:
            os.environ["DGDM_NATIVE_IO"] = old
    return port, ours, ref, theirs


@pytest.mark.parametrize("study", [0, 1])
def test_process_study_equals_jax(studies, study):
    port, ours, ref, theirs = studies
    a, b = ours[study], theirs[study]
    assert a["sop_instance_uid"] == b["sop_instance_uid"] == f"1.2.{study}"
    assert a["prediction"] == b["prediction"] and a["ehr_status"] == b["ehr_status"] == "recorded"
    assert abs(a["confidence"] - b["confidence"]) <= 1e-4
    obs = port.ehr.outbox[study]
    assert obs["subject"] == ref.ehr.outbox[study]["subject"]
    assert obs["subject"]["reference"] != "Patient/MRN 1234567"
    assert obs["valueCodeableConcept"]["text"] == ["a", "b", "c"][a["prediction"]]
    assert port.processed[study] == a


def test_process_study_refuses_surviving_phi():
    class Leaky(tcl.DICOMHandler):
        def anonymize(self, meta):
            return meta

    class NoPredictor:
        def predict_slide(self, *a, **k):
            raise AssertionError("the slide must not be read")
    man = tcl.PACSEHRIntegrationManager(NoPredictor(), dicom_handler=Leaky())
    with pytest.raises(ValueError, match="PHI"):
        man.process_study("slide.tif", ATTRS)
    assert man.processed == [] and man.ehr.outbox == []
