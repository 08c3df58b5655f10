"""The port's serving tier against the JAX package's, on the CPU
(``device="cpu"``, ``--device cpu``), f32, over one JAX bundle: the server
with dynamic batching, its Prometheus text, rate limiting, warmup, health
report and error bodies, and ``dgdm-serve`` as a subprocess (ready, answers,
SIGTERM -> exit 0). Every server binds port 0.

Tolerances: answers of the two packages agree within 1e-5 (f32 on both
sides, the JAX side with float32 matmuls); a batched answer of the port
equals ``predict_batch`` of the padded batch it rode in to the bit (JSON
carries float32 exactly); counters, keys, statuses, error bodies and metric
lines (latency values aside) are equal."""

import http.client
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from conftest import make_synthetic_graph
from dgdm_histopath_torch.cli import serve as tserve
from dgdm_histopath_torch.data import load_graph, save_graph
from dgdm_histopath_torch.deployment import InferenceServer
from dgdm_histopath_torch.deployment import serving as tserving
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.utils import dependency_check, monitoring, security
from dgdm_histopath_torch.utils.exceptions import SecurityError
from dgdm_histopath_tpu.cli import serve as jserve
from dgdm_histopath_tpu.deployment import InferenceServer as JaxServer
from dgdm_histopath_tpu.deployment import serving as jserving
from dgdm_histopath_tpu.evaluation import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.training.checkpoint import save_model_bundle
from dgdm_histopath_tpu.utils import security as jsecurity
from test_torch_training import to_torch_graph

REPO = Path(__file__).resolve().parents[1]
CFG = dict(node_features=16, hidden_dims=[32, 16], num_diffusion_steps=3,
           attention_heads=4, graph_layers=2, num_classes=3, compute_dtype="float32")
BATCHED_KEYS = {"graph_embedding", "probabilities", "predicted_class", "confidence",
                "uncertainty", "attention_weights", "latency_s"}


@pytest.fixture(autouse=True, scope="module")
def _package_loggers_put_back():
    """``dgdm-serve``'s ``main`` calls ``setup_logging``, which stops the
    package's records at its own logger; put both loggers back after this
    file, so that the tests after it still see records through ``caplog``."""
    loggers = [logging.getLogger(n) for n in ("dgdm_histopath_torch", "dgdm_histopath_tpu")]
    saved = [(lg.level, lg.propagate, list(lg.handlers)) for lg in loggers]
    yield
    for lg, (level, propagate, handlers) in zip(loggers, saved):
        lg.setLevel(level)
        lg.propagate = propagate
        lg.handlers[:] = handlers


@pytest.fixture(scope="module")
def f32_jax():
    """float32 matmuls on the JAX side in every thread (the JAX batcher's too)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "float32")
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, f32_jax):
    """(bundle, JAX predictor, port predictor, JAX graphs, graph file root)."""
    root = tmp_path_factory.mktemp("serve")
    graphs = [make_synthetic_graph(n_nodes=64, n_real=50, feat_dim=16, seed=s) for s in range(4)]
    for i, g in enumerate(graphs):
        save_graph(to_torch_graph(g), root / "graphs" / f"g{i}_graph.npz")
    model = JaxDGDM(**CFG)
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    g0 = jax.tree_util.tree_map(lambda a: a[None], graphs[0])
    params = jax.jit(lambda: model.init(rngs, g0, mode="pretrain", deterministic=True))()
    bundle = save_model_bundle(root / "m.npz", params, CFG)
    jax_pred = JaxPredictor(model=model, params=params, feature_extractor="none")
    jax_pred.predict_graph(graphs[0])          # compiled before any timed request
    port_pred = DGDMPredictor(model_path=bundle, device="cpu", feature_extractor="none")
    return bundle, jax_pred, port_pred, graphs, root


def _port_of(server) -> int:
    return server._httpd.server_address[1]


def _call(port, method, path, body=None, headers=None):
    """(status, decoded body: JSON where it parses, else text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, body=data, headers=headers or (
            {"Content-Type": "application/json"} if data else {}))
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(text)
    except json.JSONDecodeError:
        return resp.status, text


def _graph_json(g):
    return {f: np.asarray(getattr(g, f)).tolist()
            for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}


def _serve(server_cls, predictor, **kw):
    kw.setdefault("rate_limit_per_s", 1000.0)
    server = server_cls(predictor, port=0, **kw)
    server.start(background=True)
    return server


def _concurrent_predicts(port, bodies):
    out = [None] * len(bodies)

    def call(i):
        out[i] = _call(port, "POST", "/predict", bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_batched_predicts_answer_like_the_jax_server(setup):
    _, jax_pred, port_pred, graphs, _ = setup
    bodies = [{"graph": _graph_json(graphs[i % 4])} for i in range(8)]
    answers = {}
    for name, cls, pred in (("jax", JaxServer, jax_pred), ("port", InferenceServer, port_pred)):
        server = _serve(cls, pred, dynamic_batch=4, batch_wait_ms=20)
        try:
            answers[name] = _concurrent_predicts(_port_of(server), bodies)
            assert server.batcher.stats["items"] == 8
        finally:
            server.stop()
    for (js, j), (ts, t) in zip(answers["jax"], answers["port"]):
        assert js == ts == 200
        assert set(t) == set(j) == BATCHED_KEYS
        for key in ("probabilities", "graph_embedding", "attention_weights"):
            np.testing.assert_allclose(t[key], j[key], atol=1e-5, err_msg=key)
        assert t["predicted_class"] == j["predicted_class"]


def test_batched_results_lack_the_single_graph_keys_as_in_the_reference(setup):
    """predict_batch returns no logits or biomarkers in either package, so a
    /predict answered through the batcher has fewer keys than one without."""
    _, _, port_pred, graphs, _ = setup
    body = {"graph": _graph_json(graphs[0])}
    keys = {}
    for batch in (0, 4):
        server = _serve(InferenceServer, port_pred, dynamic_batch=batch)
        try:
            status, res = _call(_port_of(server), "POST", "/predict", body)
            assert status == 200
            keys[batch] = set(res)
        finally:
            server.stop()
    assert keys[4] == BATCHED_KEYS
    assert keys[0] - keys[4] == {"logits", "biomarkers"}


def test_each_batched_answer_is_its_padded_batch_to_the_bit(setup):
    _, _, port_pred, graphs, _ = setup
    seen = []
    real = port_pred.predict_batch

    def spy(batch):
        results = real(batch)
        seen.append((batch, results))
        return results

    port_pred.predict_batch = spy
    server = _serve(InferenceServer, port_pred, dynamic_batch=4, batch_wait_ms=20)
    try:
        bodies = [{"graph": _graph_json(graphs[i % 4])} for i in range(11)]
        answers = _concurrent_predicts(_port_of(server), bodies)
    finally:
        server.stop()
        del port_pred.predict_batch
    assert sum(len(b) for b, _ in seen) >= 11
    assert all(len(b) in (1, 2, 4) for b, _ in seen)        # powers of two
    by_x = {}
    for batch, results in seen:
        for g, r in zip(batch, results):
            by_x.setdefault(g.x.numpy().tobytes(), []).append(r)
    for body, (status, res) in zip(bodies, answers):
        assert status == 200
        x = np.asarray(body["graph"]["x"], np.float32).tobytes()
        assert any(np.array_equal(np.asarray(res["probabilities"], np.float32),
                                  r["probabilities"])
                   and np.array_equal(np.asarray(res["attention_weights"], np.float32),
                                      r["attention_weights"]) for r in by_x[x])


def test_mixed_buckets_pad_per_shape_group(setup):
    """3 graphs of one bucket and 1 of another in one batch: each shape group
    padded to a power of two (3 -> 4, 1 -> 1), results from their own slots."""
    _, _, port_pred, _, _ = setup
    server = InferenceServer(port_pred, port=0, dynamic_batch=8)
    seen = []
    real = port_pred.predict_batch

    def spy(graphs):
        sizes = {}
        for g in graphs:
            key = (g.num_nodes, g.max_neighbors, g.feature_dim)
            sizes[key] = sizes.get(key, 0) + 1
        seen.append(sorted(sizes.values()))
        return real(graphs)

    port_pred.predict_batch = spy
    try:
        gs = [to_torch_graph(make_synthetic_graph(seed=i, n_nodes=16, n_real=12, feat_dim=16))
              for i in range(3)]
        gs.append(to_torch_graph(make_synthetic_graph(seed=9, n_nodes=32, n_real=20,
                                                      feat_dim=16)))
        results = server.batcher.batch_fn(gs)
    finally:
        del port_pred.predict_batch
        server.batcher.close()
    assert seen == [[1, 4]]
    assert len(results) == 4
    for g, r in zip(gs, results):     # batch 4 against batch 1: f32 rounding of the GEMMs
        np.testing.assert_allclose(r["probabilities"],
                                   port_pred.predict_batch([g])[0]["probabilities"], atol=1e-6)
    assert not np.allclose(results[0]["graph_embedding"], results[1]["graph_embedding"])


def _metric_lines(text):
    """The exposition with the latency values blanked."""
    return [re.sub(r"^(dgdm_request_latency_seconds_\w+) .*$", r"\1 <v>", line)
            for line in text.splitlines()]


@pytest.mark.parametrize("dynamic_batch", [0, 4])
def test_metrics_text_equals_the_jax_text(setup, dynamic_batch):
    _, jax_pred, port_pred, graphs, _ = setup
    texts = {}
    for name, cls, pred in (("jax", JaxServer, jax_pred), ("port", InferenceServer, port_pred)):
        server = _serve(cls, pred, dynamic_batch=dynamic_batch)
        try:
            port = _port_of(server)
            for g in graphs[:3]:
                assert _call(port, "POST", "/predict", {"graph": _graph_json(g)})[0] == 200
            assert _call(port, "POST", "/predict", {"nothing": 1})[0] == 400
            status, texts[name] = _call(port, "GET", "/metrics")
            assert status == 200
        finally:
            server.stop()
    assert _metric_lines(texts["port"]) == _metric_lines(texts["jax"])
    assert "dgdm_requests_total 3" in texts["port"] and "dgdm_errors_total 1" in texts["port"]
    assert ("dgdm_batches_total 3" in texts["port"]) == (dynamic_batch > 0)


def test_rate_limit_answers_429_at_the_same_request(setup):
    _, jax_pred, port_pred, graphs, _ = setup
    body = {"graph": _graph_json(graphs[0])}
    statuses, stats = {}, {}
    for name, cls, pred in (("jax", JaxServer, jax_pred), ("port", InferenceServer, port_pred)):
        server = _serve(cls, pred, rate_limit_per_s=0.5)     # burst 1, one token per 2 s
        try:
            statuses[name] = [_call(_port_of(server), "POST", "/predict", body)[0]
                              for _ in range(6)]
            stats[name] = dict(server.stats)
        finally:
            server.stop()
    assert statuses["port"] == statuses["jax"] == [200] + [429] * 5
    assert stats["port"]["requests"] == stats["jax"]["requests"] == 1
    assert stats["port"]["errors"] == stats["jax"]["errors"] == 0


def test_429_comes_after_the_route_and_before_the_body(setup):
    port_pred = setup[2]
    server = _serve(InferenceServer, port_pred, rate_limit_per_s=0.01)   # burst 0
    try:
        port = _port_of(server)
        assert _call(port, "POST", "/nowhere", {})[0] == 404
        # a body that never comes: a server that read it would wait
        t0 = time.perf_counter()
        status, res = _call(port, "POST", "/predict", None,
                            headers={"Content-Length": str(10 ** 9)})
        assert status == 429 and res == {"error": "rate limit exceeded"}
        assert time.perf_counter() - t0 < 30
        assert _call(port, "GET", "/healthz")[0] == 200
    finally:
        server.stop()


@pytest.mark.parametrize("dynamic_batch,sizes", [(0, 1), (4, 3), (16, 5)])
def test_warmup_runs_each_power_of_two(setup, dynamic_batch, sizes):
    _, jax_pred, port_pred, _, _ = setup
    server = InferenceServer(port_pred, port=0, dynamic_batch=dynamic_batch)
    seen = []
    real = port_pred.predict_batch
    port_pred.predict_batch = lambda gs: seen.append(len(gs)) or real(gs)
    try:
        assert server.warmup(num_nodes=64, max_neighbors=8) == sizes
    finally:
        del port_pred.predict_batch
        if server.batcher is not None:
            server.batcher.close()
    assert seen == [2 ** i for i in range(sizes)]
    if dynamic_batch <= 4:
        jserver = JaxServer(jax_pred, port=0, dynamic_batch=dynamic_batch)
        try:
            assert jserver.warmup(num_nodes=64, max_neighbors=8) == sizes
        finally:
            if jserver.batcher is not None:
                jserver.batcher.close()


def test_healthz_reports_the_jax_checks(setup):
    _, jax_pred, port_pred, _, _ = setup
    reports = {}
    for name, cls, pred in (("jax", JaxServer, jax_pred), ("port", InferenceServer, port_pred)):
        server = _serve(cls, pred)
        try:
            for path in ("/healthz", "/readyz", "/health"):
                status, reports[name] = _call(_port_of(server), "GET", path)
                assert status == 200, (name, reports[name])
        finally:
            server.stop()
    assert set(reports["port"]["checks"]) == set(reports["jax"]["checks"]) == {
        "host_memory", "devices", "model_loaded", "dependencies"}
    assert reports["port"]["healthy"] and all(reports["port"]["checks"].values())


def test_error_bodies_equal_the_jax_bodies(setup, tmp_path):
    _, jax_pred, port_pred, _, root = setup
    bad = [("/predict", {"nothing": 1}), ("/predict_batch", {"nothing": 1}),
           ("/predict_slide", {}), ("/predict", {"graph": {"x": [[0.0]]}}),
           ("/predict", {"graph_path": "graphs/g0_graph.npz"})]
    escapes = [("/predict", {"graph_path": "../outside.npz"}),
               ("/predict_batch", {"graph_paths": ["/etc/hostname"]})]
    bodies = {}
    for name, cls, pred in (("jax", JaxServer, jax_pred), ("port", InferenceServer, port_pred)):
        plain, rooted = _serve(cls, pred), _serve(cls, pred, data_root=str(root))
        try:
            bodies[name] = [_call(_port_of(plain), "POST", p, b) for p, b in bad]
            bodies[name] += [_call(_port_of(rooted), "POST", p, b) for p, b in escapes]
        finally:
            plain.stop()
            rooted.stop()
    assert bodies["port"] == bodies["jax"]
    assert all(status == 400 for status, _ in bodies["port"])
    assert bodies["port"][0][1] == {"error": "payload must contain 'graph' or 'graph_path'"}
    assert bodies["port"][3][1] == {"error": "'nbr_idx'"}


def test_jsonable_drops_arrays_above_4m_elements_like_jax():
    obj = {"big": np.zeros(4_000_001, np.int8), "edge": np.zeros(4_000_000, np.int8),
           "small": np.arange(3, dtype=np.float32), "scalar": np.float32(0.5),
           "n": np.int64(3), "flag": np.bool_(True), "nested": [{"a": np.ones(2)}, (1, "s")]}
    ours = tserving._jsonable(obj)
    assert ours == jserving._to_jsonable(obj)
    assert ours["big"] is None and len(ours["edge"]) == 4_000_000
    json.dumps(ours)


def test_stop_closes_the_batcher(setup):
    server = _serve(InferenceServer, setup[2], dynamic_batch=2)
    server.stop()
    assert not server.batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        server.batcher.submit(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dgdm_serve_cli_on_the_cpu_answers_and_stops_on_sigterm(setup):
    bundle, jax_pred, _, graphs, root = setup
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgdm_histopath_torch.cli.serve", "--model", str(bundle),
         "--port", str(port), "--device", "cpu", "--data-root", str(root),
         "--dynamic-batch", "4", "--warmup-nodes", "64", "--rate-limit", "1000",
         "--log-level", "INFO"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                if _call(port, "GET", "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server not ready"
            time.sleep(0.2)
        answers = _concurrent_predicts(
            port, [{"graph_path": f"graphs/g{i}_graph.npz"} for i in range(4)])
        for g, (status, res) in zip(graphs, answers):
            assert status == 200
            ref = jax_pred.predict_graph(g)
            np.testing.assert_allclose(res["probabilities"], ref["probabilities"], atol=1e-5)
        status, text = _call(port, "GET", "/metrics")
        assert status == 200 and "dgdm_requests_total 4" in text
        assert "dgdm_batches_total" in text
        status, info = _call(port, "GET", "/info")
        assert status == 200 and info["device"] == "cpu"
        assert info["serving_stats"]["requests"] == 4
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert f"inference server on :{port}" in out and "server stopped" in out
    assert out.count("warmup: nodes=64") == 3


def test_dgdm_serve_without_a_card_refuses_to_start(setup, monkeypatch, capsys):
    """No ``--device cpu`` and no card: an error, never a server on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--model", str(setup[0]), "--port", "0", "--log-level", "ERROR"])
    assert exc.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err


def test_dgdm_serve_quant_int8_serves_the_int8_forward(setup, monkeypatch):
    """``dgdm-serve --quant int8`` in this process: a /predict through the
    dynamic batcher and a /predict_batch, each through ``int8_apply``, equal
    to ``DGDMPredictor(quant="int8")``; stopped, it returns 0."""
    from dgdm_histopath_torch import deployment
    from dgdm_histopath_torch.evaluation import predictor as tpred

    bundle, _, _, _, root = setup
    servers, calls, answers = [], [], {}

    class Recorded(InferenceServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)
    monkeypatch.setattr(deployment, "InferenceServer", Recorded)
    int8_apply = tpred.int8_apply
    monkeypatch.setattr(tpred, "int8_apply", lambda *a, **k: calls.append(1) or
                        int8_apply(*a, **k))

    def client():
        deadline = time.monotonic() + 120
        while not (servers and getattr(servers[0], "_httpd", None)):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        try:
            port = _port_of(servers[0])
            while _call(port, "GET", "/readyz")[0] != 200:
                time.sleep(0.05)
            answers["one"] = _call(port, "POST", "/predict",
                                   {"graph_path": "graphs/g0_graph.npz"})
            answers["batch"] = _call(port, "POST", "/predict_batch", {
                "graph_paths": ["graphs/g1_graph.npz", "graphs/g2_graph.npz"]})
        finally:
            servers[0].stop()
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    assert tserve.main(["--model", str(bundle), "--device", "cpu", "--quant", "int8",
                        "--port", "0", "--dynamic-batch", "4", "--data-root", str(root),
                        "--log-level", "ERROR"]) == 0
    thread.join(timeout=60)
    assert servers[0].predictor.quant == "int8" and len(calls) == 2
    pred = DGDMPredictor(model_path=bundle, device="cpu", feature_extractor="none", quant="int8")
    want = pred.predict_batch([load_graph(root / "graphs" / f"g{i}_graph.npz") for i in range(3)])
    (s1, one), (s2, batch) = answers["one"], answers["batch"]
    assert s1 == s2 == 200 and batch["count"] == 2
    for got, ref in zip([one, *batch["results"]], want):
        assert got["predicted_class"] == ref["predicted_class"]
        np.testing.assert_allclose(got["probabilities"], ref["probabilities"], atol=1e-6)


def test_dgdm_serve_flags_are_the_jax_flags():
    def options(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = options(tserve.build_parser()), options(jserve.build_parser())
    assert ours.pop("device") == (["--device"], "cuda", None, ["cuda", "cpu"])
    assert ours == theirs


@pytest.mark.parametrize("rate,burst", [(2.0, 4), (0.5, 1), (10.0, 20)])
def test_rate_limiter_allows_what_the_jax_limiter_allows(monkeypatch, rate, burst):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    ours, theirs = security.RateLimiter(rate, burst), jsecurity.RateLimiter(rate, burst)
    rs = np.random.RandomState(int(rate * 10))
    decisions = []
    for _ in range(200):
        clock[0] += float(rs.exponential(0.1 / rate))   # each key at ~3x its rate
        key = f"ip{rs.randint(3)}"
        d = ours.allow(key)
        assert d == theirs.allow(key)
        decisions.append(d)
    assert 0 < sum(decisions) < 200
    while ours.allow("drain"):
        pass
    with pytest.raises(SecurityError, match="rate limit exceeded"):
        ours.check("drain")


def test_dependency_report_names_torch_and_the_port_lists():
    report = dependency_check.check_dependencies()
    assert dependency_check.REQUIRED == ["torch", "numpy"]
    assert report["healthy"] and report["missing_required"] == []
    assert set(report["optional"]) == {"yaml", "h5py", "PIL", "openslide", "scipy",
                                       "matplotlib", "plotly"}
    import torch
    assert report["torch"]["version"] == torch.__version__
    assert report["torch"]["cuda"] == torch.version.cuda
    assert report["torch"]["device_count"] == len(report["torch"]["devices"])
    assert "jax" not in report
    dependency_check.assert_healthy()


def test_health_checker_aggregates_named_checks():
    hc = monitoring.HealthChecker()
    report = hc.check()
    assert set(report["checks"]) == {"host_memory", "devices"} and report["healthy"]
    hc.register("broken", lambda: False)
    hc.register("raising", lambda: 1 / 0)
    report = hc.check()
    assert not report["healthy"]
    assert report["checks"]["broken"] is False and report["checks"]["raising"] is False
    assert isinstance(monitoring.device_memory_stats(), dict)


def test_profiler_trace_writes_a_tensorboard_trace(tmp_path):
    import torch
    with monitoring.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    files = list((tmp_path / "trace").iterdir())
    assert files and files[0].name.endswith(".pt.trace.json")
