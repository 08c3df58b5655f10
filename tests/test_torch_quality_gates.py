"""The port's quality gates, their cache, their parallel runner and
``dgdm-quality`` against the JAX package's, on the CPU.

The gates' tiny graph equals the JAX one (indices and masks to the bit,
edge features within 1e-6); the score and the pass rule equal JAX's at each
level over the same stubbed gate outcomes; the port's whole ``production``
run passes on the CPU (the JAX package's own model gates run in
tests/test_cli.py, not again here); a second cached run serves the passed
gates and not the failed one; an edit to a ``.py`` or a ``.cu`` file changes
the fingerprint; the JAX cache reads the port's entries; the CLI's flags,
and the process mode with the device passed on.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

import dgdm_histopath_torch.testing as tt
import dgdm_histopath_tpu.testing as jt
from dgdm_histopath_torch.cli.quality_gates import main as port_cli
from dgdm_histopath_torch.testing import autonomous as t_auto
from dgdm_histopath_torch.testing import quality_gates as tq
from dgdm_histopath_torch.testing import scalable_gates as ts
from dgdm_histopath_tpu.testing import autonomous as j_auto
from dgdm_histopath_tpu.testing import quality_gates as jq
from dgdm_histopath_tpu.testing import scalable_gates as js

CHEAP = ["imports", "config", "input_validation"]


def test_exports_levels_and_gate_names_match_jax():
    assert sorted(tt.__all__) == sorted(jt.__all__)
    assert tq.LEVEL_REQUIREMENTS == jq.LEVEL_REQUIREMENTS
    assert list(tq.GATES) == list(jq.GATES)
    assert set(tq.MODEL_GATES) <= set(tq.GATES)


def test_tiny_graph_matches_jax():
    for kw in (dict(num_classes=2), dict(b=1), dict(feat_dim=5, b=1)):
        with jax.default_matmul_precision("float32"):
            ref = jq._tiny_graph(**kw)
        got = tq._tiny_graph(**kw)
        for f in ("x", "pos", "nbr_idx", "nbr_mask", "node_mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
        np.testing.assert_allclose(got.edge_attr.numpy(), np.asarray(ref.edge_attr), atol=1e-6,
                                   rtol=0)
        assert (got.y is None) == (ref.y is None)
        if ref.y is not None:
            np.testing.assert_array_equal(got.y.numpy(), np.asarray(ref.y))


def _stub(monkeypatch, failing):
    """Both packages' GATES replaced by stubs that fail for ``failing``."""
    def make(name, port):
        def gate(*device):
            assert len(device) == int(port)
            if name in failing:
                raise RuntimeError(f"{name} stubbed to fail")
        return gate
    for gates, port in ((tq.GATES, True), (jq.GATES, False)):
        for name in list(gates):
            monkeypatch.setitem(gates, name, make(name, port))


def _essence(report):
    return (report["score"], report["passed"], report["level"],
            [(g["name"], g["status"]) for g in report["gates"]])


OUTCOMES = [((), None, False), (("serving",), None, False), (("imports",), None, False),
            (("preprocessing", "serving", "determinism"), None, False),
            (("config",), ["config", "no_such_gate", "imports"], False),
            (("training_step",), None, True), (("determinism",), CHEAP + ["determinism"], True)]


@pytest.mark.parametrize("level", ["greenfield", "development", "staging", "production"])
def test_score_and_pass_rule_match_jax(level, monkeypatch):
    for failing, selected, fail_fast in OUTCOMES:
        _stub(monkeypatch, failing)
        got = tq.QualityGateRunner(level, fail_fast=fail_fast, device="cpu").run(selected)
        ref = jq.QualityGateRunner(level, fail_fast=fail_fast).run(selected)
        assert _essence(got) == _essence(ref), (failing, selected)
        if ref["gates"][-1]["status"] == "failed":
            assert "stubbed to fail" in got["gates"][-1]["error"]


def test_the_production_gates_pass_on_the_cpu():
    report = tq.QualityGateRunner("production", device="cpu").run()
    bad = {g["name"]: g["error"] for g in report["gates"] if g["status"] != "passed"}
    assert not bad and report["passed"] and report["score"] == 1.0
    assert [g["name"] for g in report["gates"]] == list(tq.GATES)


def test_the_cache_serves_passes_not_failures_and_jax_reads_it(tmp_path, monkeypatch):
    _stub(monkeypatch, ("determinism",))
    names = CHEAP + ["determinism"]
    first = ts.ScalableQualityGateRunner("staging", cache_dir=tmp_path, max_workers=2,
                                         device="cpu").run(names)
    assert first["cache_hits"] == 0 and not any(g.get("cached") for g in first["gates"])
    second = ts.ScalableQualityGateRunner("staging", cache_dir=tmp_path, max_workers=2,
                                          device="cpu").run(names)
    assert second["cache_hits"] == 3
    assert [g.get("cached", False) for g in second["gates"]] == [True, True, True, False]
    assert _essence(second) == _essence(first)
    # the JAX package's cache reads the port's entries under the same key
    fp, meta = ts.package_fingerprint(), {"level": "staging", "device": "cpu"}
    jcache = js.GateResultCache(tmp_path)
    for name in CHEAP:
        entry = jcache.get(name, fp, meta)
        assert entry["status"] == "passed" and entry["name"] == name and entry["cache_hits"] == 2
    assert jcache.get("determinism", fp, meta) is None
    assert jcache.get("determinism", fp, meta, serve_failures=True)["status"] == "failed"
    assert jcache.stats()["unique_gates"] == 4
    # another device or level is another key
    assert ts.GateResultCache(tmp_path).get("imports", fp, {"level": "staging",
                                                            "device": "cuda"}) is None


def test_the_fingerprint_follows_py_and_cu_edits(tmp_path):
    (tmp_path / "ops").mkdir()
    py, cu = tmp_path / "ops" / "a.py", tmp_path / "k.cu"
    py.write_text("x = 1\n")
    cu.write_text("__global__ void k() {}\n")
    fp0 = ts.package_fingerprint(tmp_path)
    (tmp_path / "k.so").write_bytes(b"\0" * 8)          # a build output: not hashed
    assert ts.package_fingerprint(tmp_path) == fp0
    cu.write_text("__global__ void k() { }\n")
    fp1 = ts.package_fingerprint(tmp_path)
    py.write_text("x = 2  \n")
    fp2 = ts.package_fingerprint(tmp_path)
    assert len({fp0, fp1, fp2}) == 3
    assert js.package_fingerprint(tmp_path) != fp2      # JAX hashes no .cu file
    assert len(ts.package_fingerprint()) == 64


def test_process_mode_passes_the_device_on():
    report = ts.ScalableQualityGateRunner("greenfield", max_workers=2, mode="process",
                                          device="cpu").run(CHEAP)
    assert [(g["name"], g["status"]) for g in report["gates"]] == [(n, "passed") for n in CHEAP]
    with pytest.raises(ValueError):
        ts.ScalableQualityGateRunner(mode="fork", device="cpu")


@pytest.fixture
def package_logger():
    """The CLI's ``setup_logging`` takes the package's logger off the root:
    put it back after the test."""
    lg = logging.getLogger("dgdm_histopath_torch")
    saved = (lg.level, lg.propagate, list(lg.handlers))
    yield
    lg.setLevel(saved[0])
    lg.propagate = saved[1]
    lg.handlers[:] = saved[2]


def test_cli_flags(tmp_path, capsys, monkeypatch, package_logger):
    out = tmp_path / "report.json"
    rc = port_cli(["--level", "greenfield", "--gates", "imports,config", "--device", "cpu",
                   "--output", str(out), "--log-level", "WARNING"])
    summary = json.loads(capsys.readouterr().out)
    assert rc == 0 and summary == {"score": 1.0, "passed": True, "level": "greenfield",
                                   "gates": {"imports": "passed", "config": "passed"}}
    assert [g["name"] for g in json.loads(out.read_text())["gates"]] == ["imports", "config"]
    args = ["--gates", ",".join(CHEAP), "--device", "cpu", "--parallel", "2",
            "--cache-dir", str(tmp_path / "cache"), "--log-level", "WARNING"]
    assert port_cli(args) == 0 and json.loads(capsys.readouterr().out)["cache_hits"] == 0
    assert port_cli(args) == 0 and json.loads(capsys.readouterr().out)["cache_hits"] == 3
    assert port_cli(["--gates", "no_such_gate", "--device", "cpu", "--fail-fast",
                     "--log-level", "WARNING"]) == 1
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_cli(["--gates", "imports"])
    assert exc.value.code == 2 and "--device cpu" in capsys.readouterr().err


def test_autonomous_runner_matches_jax(tmp_path, monkeypatch):
    _stub(monkeypatch, ("serving",))
    got = t_auto.AutonomousTestRunner(tmp_path / "t", level="staging", device="cpu").run()
    ref = j_auto.AutonomousTestRunner(tmp_path / "j", level="staging").run()
    for r in (got, ref):
        r["tests"]["results"] = [(x["name"], x["status"]) for x in r["tests"]["results"]]
        r["quality_gates"] = _essence(r["quality_gates"])
        r.pop("timestamp"), r.pop("duration_s")
    assert got == ref and got["overall_pass"] is False
    assert json.loads((tmp_path / "t" / "autonomous_report.json").read_text())["tests"][
        "passed"] == 12
    suite = t_auto.DGDMTestSuite(device="cpu")
    suite.register("extra", lambda: None)
    assert [r["name"] for r in suite.run(pattern="extra")] == ["extra"]
