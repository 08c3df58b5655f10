"""The port's staged accuracy gates (``dgdm_histopath_torch/scripts/``), the
ported examples' entry points, and the public names the slice adds, against
the repository's JAX-side scripts (``scripts/``, imported with ``scripts/`` on
``sys.path`` as ``tests/test_gate_harness.py`` does) and the JAX package, on
the CPU.

Tolerances: graphs read from the committed cache equal field for field;
test probabilities of carried-over parameters within 1e-5 (f32 models on
both sides; 7.4e-8 dense and 3.0e-8 window32 measured); pooled reports on
the committed arms within 1e-12 (the same numpy arithmetic on the same
arrays); the heads' losses within 1e-6.
"""

import argparse
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import aggregate_hard_seeds as jagg  # noqa: E402
import gate_harness as jgate  # noqa: E402

from dgdm_histopath_tpu.models import decoders as jdec  # noqa: E402
from dgdm_histopath_tpu.models.dgdm import DGDMModel as JaxDGDM  # noqa: E402
from dgdm_histopath_tpu.ops.graph import batch_graphs as jbatch  # noqa: E402
from dgdm_histopath_torch.convert import flatten_flax, load_state, params_from_flax  # noqa: E402
from dgdm_histopath_torch.models import decoders as tdec  # noqa: E402
from dgdm_histopath_torch.models.dgdm import DGDMModel  # noqa: E402
from dgdm_histopath_torch.scripts import aggregate_hard_seeds as tagg  # noqa: E402
from dgdm_histopath_torch.scripts import eval_camelyon16 as tc16  # noqa: E402
from dgdm_histopath_torch.scripts import gate_harness as tgate  # noqa: E402

C16 = REPO / "docs" / "results" / "c16_hard"
TCGA = REPO / "docs" / "results" / "tcga_hard"
GRAPH_FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        raise SystemExit(f"usage error: {message}")


def _args(**kw):
    base = dict(window=None, ab_window=False, moe_experts=0, ab_pretrain=False, ab_int8=False)
    return argparse.Namespace(**{**base, **kw})


VARIANT_CASES = {
    "defaults": {},
    "window_alone": dict(window="32"),
    "window_list_ab": dict(window="32,8", ab_window=True),
    "moe_and_pretrain": dict(moe_experts=4, ab_pretrain=True),
    "every_arm": dict(window="16", ab_window=True, ab_int8=True, moe_experts=4,
                      ab_pretrain=True),
    "int8_alone": dict(ab_int8=True),
    "int8_without_dense": dict(window="32", ab_int8=True),
}


@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_build_variants_matches_jax(case):
    args = _args(**VARIANT_CASES[case])
    try:
        ref = jgate.build_variants(args, _Parser())
    except SystemExit as exc:
        with pytest.raises(SystemExit) as ours:
            tgate.build_variants(args, _Parser())
        assert str(ours.value) == str(exc)
        assert "no dense arm" in str(exc)
        return
    assert tgate.build_variants(args, _Parser()) == ref


@pytest.mark.parametrize("tag", ["", "_simple_cnn-stats", "_w32"])
def test_slide_to_graph_reads_the_committed_cache_as_jax_does(tag):
    cache = C16 / "graph_cache"
    path = C16 / "synthetic_data" / "training" / "normal" / "normal_0001.tiff"   # not on disk
    ref = jgate.slide_to_graph(path, 1, None, None, cache, 256, tag)
    got = tgate.slide_to_graph(path, 1, None, None, cache, 256, tag)
    for f in GRAPH_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(got.n_real_nodes) == int(ref.n_real_nodes)


def _cached_graphs(tag, n=8):
    files = sorted((C16 / "graph_cache").glob(f"*_b256{tag}.npz"))[:n]
    labels = [int("tumor" in f.name) for f in files]
    jg = [jgate.slide_to_graph(f.parent / f.name.split("_b256")[0], y, None, None, f.parent,
                               256, tag) for f, y in zip(files, labels)]
    tg = [tgate.slide_to_graph(f.parent / f.name.split("_b256")[0], y, None, None, f.parent,
                               256, tag) for f, y in zip(files, labels)]
    return jg, tg


MODEL_KW = dict(node_features=512, hidden_dims=(32, 16), attention_heads=4,
                num_diffusion_steps=10, graph_layers=2, num_classes=2, pooling="attention",
                compute_dtype="float32")
WINDOW = {"spatial_window": 32, "graph_window": 32}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's parameters (the windows add none: one set serves both
    arms), drawn once."""
    jg, _ = _cached_graphs("")
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    jm = JaxDGDM(**MODEL_KW)
    with jax.default_matmul_precision("float32"):
        return jax.device_get(jax.jit(lambda g: jm.init(rngs, g, mode="pretrain",
                                                        deterministic=True))(jbatch(jg[:4])))


@pytest.mark.parametrize("arm", ["dense", "window32"])
def test_predict_probs_matches_the_jax_forward(arm, jax_params):
    """The harness's predict_probs on 8 committed graphs (the window arm's
    band-built ones for window32) with the JAX parameters carried over
    equals JAX's jitted inference forward."""
    kw = dict(MODEL_KW, **(WINDOW if arm == "window32" else {}))
    jg, tg = _cached_graphs("_w32" if arm == "window32" else "")
    assert len(tg) == 8
    jm = JaxDGDM(**kw)
    with jax.default_matmul_precision("float32"):
        fwd = jax.jit(lambda p, g: jm.apply(p, g, mode="inference",
                                            deterministic=True)["classification_logits"])
        logits = np.concatenate([np.asarray(fwd(jax_params, jbatch(jg[i:i + 4])), np.float64)
                                 for i in (0, 4)])
    ref = np.exp(logits - logits.max(-1, keepdims=True))
    ref /= ref.sum(-1, keepdims=True)
    model = DGDMModel(**kw)
    load_state(model, params_from_flax(flatten_flax(jax_params)))
    probs, labels = tgate.predict_probs(model, tg, 4)
    assert probs.shape == (8, 2) and probs.dtype == np.float64
    np.testing.assert_array_equal(labels, [int(g.y) for g in jg])
    np.testing.assert_allclose(probs, ref, atol=1e-5, rtol=0)


def _numbers_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _numbers_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _numbers_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, (float, int)):
        assert abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("gate", ["c16_hard", "tcga_hard"])
def test_aggregate_matches_jax_on_the_committed_arms(gate, tmp_path):
    """Train seeds 0-2 of every committed arm (the 10 / 20 seeds cost the
    bootstrap 3-7x the time and exercise nothing more)."""
    src = C16 if gate == "c16_hard" else TCGA
    arms = [f for f in src.glob("variant_*.npz") if re.search(r"_s0(t[12])?\.npz$", f.name)]
    for f in arms + list(src.glob("report_*.json")):
        shutil.copy(f, tmp_path / f.name)
    argv = ["--dir", str(tmp_path), "--n-bootstrap", "100"]
    ours = tagg.main([*argv, "--report", "pooled_port.json", "--cpu"])
    ref = jagg.main([*argv, "--report", "pooled_jax.json"])
    _numbers_equal(ours, ref)
    assert json.loads((tmp_path / "pooled_port.json").read_text()) == ours
    assert ours["auc_metric"] == ("binary" if gate == "c16_hard" else "macro_ovr")


TINY = ["--synthetic", "--hard", "--cpu", "--n-train-per-class", "2", "--n-test-per-class",
        "2", "--slide-size", "256", "--patch-size", "32", "--bucket", "64", "--max-patches",
        "64", "--hidden", "32,16", "--pretrain-epochs", "1", "--finetune-epochs", "1",
        "--batch-size", "2", "--extractor", "stats", "--ab-int8"]
# the keys JAX's build_report writes for a one-arm run with the int8 rider
REPORT_KEYS = {"dataset", "config", "hidden_dims", "per_slide_norm", "selection", "seed",
               "train_seed", "extractor", "vit_weights", "backbone_pretrained", "n_train",
               "n_test", "bucket", "max_patches", "auc", "f1", "auc_ci95", "accuracy",
               "auc_int8", "int8_auc_delta", "reference_target", "auc_delta_vs_reference",
               "parity_valid", "preprocess_s_per_slide", "best_val_loss", "wall_s", "device",
               "real_nodes", "int8_auc_delta_ci95"}


@pytest.fixture(scope="module")
def tiny_c16(tmp_path_factory):
    out = tmp_path_factory.mktemp("c16") / "gate"
    report = tc16.main([*TINY, "--out", str(out), "--train-seed", "0,1"])
    return out, report


def test_tiny_hard_c16_run_writes_jax_shaped_reports(tiny_c16):
    out, report = tiny_c16
    assert report["dataset"] == "camelyon16-synthetic-hard" and report["train_seed"] == 1
    for name in ("report.json", "report_t1.json", "report_pooled.json"):
        assert (out / name).exists(), name
    for name in ("report.json", "report_t1.json"):
        rep = json.loads((out / name).read_text())
        assert REPORT_KEYS <= set(rep) and rep["device"] == "cpu"
        assert np.isfinite(rep["auc"]) and rep["graph_cache_misses"] == 8
    pooled = json.loads((out / "report_pooled.json").read_text())
    assert pooled["auc_metric"] == "binary" and pooled["n_test"] == 4
    assert pooled["arms"]["dense"]["train_seeds"] == [0, 1]
    assert pooled["int8_auc_delta"]["train_seeds"] == [0, 1]
    with np.load(out / "variant_dense_s0t1.npz", allow_pickle=True) as z:
        assert sorted(z.files) == ["labels", "metrics", "probs", "probs_int8"]
        assert z["probs"].shape == (4,)
        cfg = json.loads(str(z["metrics"]))["_arm_config"]
    assert cfg["backend"] == "torch" and cfg["num_classes"] == 2 and cfg["bucket"] == 64
    assert len(list((out / "graph_cache").glob("*_b64_stats_p32.npz"))) == 8
    assert len(list((out / "synthetic_data").rglob("*.tiff"))) == 8   # rendered on a miss


def test_jax_aggregator_reads_the_port_arms(tiny_c16, tmp_path):
    out, _ = tiny_c16
    for f in out.glob("variant_*.npz"):
        shutil.copy(f, tmp_path / f.name)
    argv = ["--dir", str(tmp_path), "--n-bootstrap", "50"]
    _numbers_equal(tagg.main([*argv, "--report", "a.json", "--cpu"]),
                   jagg.main([*argv, "--report", "b.json"]))


def test_rerun_resumes_every_arm_from_the_cache(tiny_c16, tmp_path):
    out, report = tiny_c16
    again = tmp_path / "gate"
    shutil.copytree(out, again)
    before = sorted(p.name for p in (again / "graph_cache").iterdir())
    rep = tc16.main([*TINY, "--out", str(again), "--train-seed", "0,1"])
    assert rep["auc"] == report["auc"] and rep["graph_cache_misses"] == 0
    assert sorted(p.name for p in (again / "graph_cache").iterdir()) == before


@pytest.mark.parametrize("jax_arm", ["fingerprinted", "unfingerprinted"])
def test_resume_into_a_jax_arm_of_the_same_tag_is_refused(tiny_c16, tmp_path, jax_arm):
    """A JAX arm (its fingerprint without a backend, or none at all, as the
    committed c16_hard arms have) is never pooled with the port's seeds."""
    out, _ = tiny_c16
    dst = tmp_path / "gate"
    dst.mkdir()
    if jax_arm == "unfingerprinted":
        shutil.copy(C16 / "variant_dense_s0.npz", dst / "variant_dense_s0.npz")
    else:
        with np.load(out / "variant_dense_s0.npz", allow_pickle=True) as z:
            arrays = {k: z[k] for k in z.files}
        metrics = json.loads(str(arrays.pop("metrics")))
        metrics["_arm_config"].pop("backend")
        np.savez(dst / "variant_dense_s0.npz", metrics=json.dumps(metrics), **arrays)
    with pytest.raises(SystemExit, match="DIFFERENT hyperparameters.*backend"):
        tc16.main([*TINY, "--out", str(dst), "--train-seed", "0"])


def _jax_graph_pair():
    rs = np.random.RandomState(0)
    n, k = 16, 4
    mask = np.zeros((3, n), bool)
    for b, real in enumerate((16, 9, 1)):
        mask[b, :real] = True
    arrays = dict(x=rs.randn(3, n, 5).astype(np.float32), pos=rs.rand(3, n, 2).astype(np.float32),
                  nbr_idx=rs.randint(0, n, (3, n, k)).astype(np.int32),
                  nbr_mask=rs.rand(3, n, k) > 0.3, edge_attr=rs.rand(3, n, k, 3).astype(np.float32),
                  node_mask=mask)
    from dgdm_histopath_tpu.ops.graph import PaddedGraph as JG
    from dgdm_histopath_torch.ops.graph import PaddedGraph as TG
    return (JG(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TG(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_padded_graph_n_real_nodes_matches_jax():
    jg, tg = _jax_graph_pair()
    got = tg.n_real_nodes
    assert got.dtype == torch.int32 and got.tolist() == [16, 9, 1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.n_real_nodes))
    assert int(tg.replace(node_mask=tg.node_mask[1]).n_real_nodes) == 9


def test_padded_graph_replace_features_matches_jax():
    jg, tg = _jax_graph_pair()
    x = np.random.RandomState(1).randn(3, 16, 7).astype(np.float32)
    got = tg.replace_features(torch.from_numpy(x))
    ref = jg.replace_features(jnp.asarray(x))
    assert got.feature_dim == ref.feature_dim == 7
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))
    assert got.nbr_idx is tg.nbr_idx and tg.x.shape[-1] == 5


@pytest.mark.parametrize("weights,smoothing", [(None, 0.0), ((0.3, 1.0, 2.5), 0.1)],
                         ids=["plain", "weighted_smoothed"])
def test_classification_head_loss_matches_jax(weights, smoothing):
    rs = np.random.RandomState(2)
    logits, labels = rs.randn(6, 3).astype(np.float32), rs.randint(0, 3, 6)
    head = tdec.ClassificationHead(4, 3, class_weights=weights, label_smoothing=smoothing)
    jhead = jdec.ClassificationHead(num_classes=3, class_weights=weights,
                                    label_smoothing=smoothing)
    got = head.loss(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = jhead.loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=0)


def test_classification_head_predict_matches_jax():
    logits = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    got = tdec.ClassificationHead.predict(torch.from_numpy(logits))
    ref = jdec.ClassificationHead.predict(jnp.asarray(logits))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("loss_type", ["mse", "mae", "huber", "gaussian_nll"])
def test_regression_head_loss_matches_jax(loss_type):
    rs = np.random.RandomState(4)
    out = {"mean": rs.randn(6, 2).astype(np.float32) * 2,
           "log_var": rs.randn(6, 2).astype(np.float32)}
    targets = rs.randn(12).astype(np.float32)
    head = tdec.RegressionHead(4, 2, predict_uncertainty=True, loss_type=loss_type,
                               huber_delta=0.7)
    jhead = jdec.RegressionHead(num_targets=2, predict_uncertainty=True, loss_type=loss_type,
                                huber_delta=0.7)
    got = head.loss({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(targets))
    ref = jhead.loss({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["cox", "discrete"])
def test_survival_head_loss_matches_jax(mode):
    rs = np.random.RandomState(5)
    out = ({"risk": rs.randn(8).astype(np.float32)} if mode == "cox"
           else {"hazard_logits": rs.randn(8, 5).astype(np.float32)})
    time = (rs.rand(8) * 10).astype(np.float32) if mode == "cox" else rs.randint(0, 7, 8)
    event = (rs.rand(8) > 0.4).astype(np.float32)
    head = tdec.SurvivalHead(4, mode=mode, num_intervals=5)
    jhead = jdec.SurvivalHead(mode=mode, num_intervals=5)
    got = head.loss({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(time),
                    torch.from_numpy(event))
    ref = jhead.loss({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(time),
                     jnp.asarray(event))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=0)


def test_native_available_reports_whether_the_reader_loads(monkeypatch):
    from dgdm_histopath_torch import native

    def broken():
        raise OSError("no compiler")
    monkeypatch.setattr(native, "get_lib", broken)
    assert native.available() is False
    monkeypatch.setattr(native, "get_lib", lambda: object())
    assert native.available() is True


def test_health_checker_serves_its_check_over_http(monkeypatch):
    """``serve_forever`` answers the probe paths with ``check()`` as JSON
    (200 when healthy, else 503) and any other path 404; the server here
    handles two requests and returns."""
    import http.server
    import socket
    import threading
    import urllib.error
    import urllib.request

    from dgdm_histopath_torch.deployment.production import ProductionHealthChecker

    class TwoRequests(http.server.HTTPServer):
        def serve_forever(self, poll_interval=0.5):
            for _ in range(2):
                self.handle_request()
            self.server_close()
    monkeypatch.setattr(http.server, "HTTPServer", TwoRequests)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    checker = ProductionHealthChecker()
    expected = checker.check()
    thread = threading.Thread(target=checker.serve_forever, args=(port,), daemon=True)
    thread.start()

    def get(path):
        for _ in range(50):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as exc:
                return exc.code, None
            except ConnectionRefusedError:
                threading.Event().wait(0.1)
            except urllib.error.URLError as exc:
                if not isinstance(exc.reason, ConnectionRefusedError):
                    raise
                threading.Event().wait(0.1)
        raise AssertionError("the health endpoint never answered")
    status, body = get("/healthz")
    assert status == (200 if expected["healthy"] else 503)
    assert body["checks"].keys() == expected["checks"].keys()
    assert get("/metrics") == (404, None)
    thread.join(timeout=10)
    assert not thread.is_alive()


ENTRY_ARGV = {
    "scripts.aggregate_hard_seeds": ["--dir", "."],
    "scripts.eval_camelyon16": ["--synthetic"],
    "scripts.eval_tcga": ["--synthetic"],
    "scripts.eval_panda": ["--synthetic"],
    "scripts.convert_timm_vit": ["in.pth", "out.npz"],
    "scripts.train_tcga": ["--data-dir", ".", "--metadata", "labels.csv"],
    "examples.basic_usage": [],
    "examples.basic_usage_simple": [],
    "examples.windowed_scaling": [],
}


@pytest.mark.parametrize("module", sorted(ENTRY_ARGV))
def test_entry_points_refuse_to_run_without_a_card_unless_told(module, tmp_path, monkeypatch):
    """No card here: without --cpu each entry point stops with a usage error
    (exit 2) before any work, and never falls back to the CPU."""
    import importlib
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"dgdm_histopath_torch.{module}").main
    with pytest.raises(SystemExit) as exc:
        main(ENTRY_ARGV[module] + ["--out", str(tmp_path / "o")]
             if module.startswith("scripts.eval") else ENTRY_ARGV[module])
    assert exc.value.code == 2
    assert not (tmp_path / "o").exists()


def test_the_new_entry_points_load_no_jax():
    """Importing every new module (and what it imports) loads neither JAX
    nor the JAX package."""
    mods = [f"dgdm_histopath_torch.{m}" for m in sorted(ENTRY_ARGV)] + [
        "dgdm_histopath_torch.scripts.gate_harness"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'dgdm_histopath_tpu')]\n"
            "print(len(bad)); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# JAX public names with no counterpart in the port, each with its reason: the
# TPU's one-hot / banded formulation of message passing (the port maps it to
# its gather kernels), the Pallas modules' tiling (the port's kernels live in
# ops/kernels/), and flax / JAX plumbing
NOT_PORTED = {
    **{f"models/{m}.py:Dtype": "flax dtype alias" for m in
       ("decoders", "dgdm", "encoders", "pooling", "vit")},
    **{f"nn/{m}.py:Dtype": "flax dtype alias" for m in
       ("attention", "diffusion", "graph_layers", "moe")},
    **{f"research/{m}.py:Dtype": "flax dtype alias" for m in
       ("multimodal_fusion", "novel_algorithms")},
    "models/decoders.py:MultiTaskHead.setup": "flax module setup",
    "models/dgdm.py:DGDMModel.setup": "flax module setup",
    "nn/diffusion.py:DiffusionLayer.setup": "flax module setup",
    "training/trainer.py:TrainState": "flax train state; the port's trainer owns its state",
    "training/trainer.py:TrainState.create": "flax train state",
    "parallel/mesh.py:data_sharding": "jax.sharding plumbing",
    "parallel/mesh.py:replicated": "jax.sharding plumbing",
    **{f"{m}.py:logger": "module logger" for m in
       ("evaluation/visualizer", "parallel/ep", "parallel/halo", "parallel/mesh",
        "parallel/pp", "parallel/sp", "parallel/tp", "preprocessing/tissue_graph_builder")},
    **{f"ops/graph.py:{n}": "TPU one-hot / banded formulation; the port gathers" for n in
       ("band_widen", "banded_conv_agg", "banded_gather_neighbors",
        "banded_relative_neighbors", "banded_weighted_adjacency", "neighbor_onehot",
        "resolve_gather_impl", "resolve_key_gather_impl", "weighted_adjacency")},
    **{f"ops/pallas/{f}.py:{n}": "Pallas tiling / VMEM eligibility" for f, n in
       (("gather_agg", "TILE_N"), ("gather_agg", "TILE_S"), ("gather_rows", "TILE_N"),
        ("gather_rows", "TILE_S"), ("gather_rows", "VMEM_BUDGET"),
        ("gather_rows", "eligible"))},
}


def _public(path: Path, with_imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{s.name}" for s in node.body
                             if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not any(p.startswith("_") for p in n.split("."))}


def test_every_public_jax_name_is_ported_or_listed():
    """An AST comparison of each JAX module with its port counterpart (the
    Pallas modules' with ops/kernels/): every public function, class,
    method and module constant exists in the port or is in NOT_PORTED."""
    jax_root, port_root = REPO / "dgdm_histopath_tpu", REPO / "dgdm_histopath_torch"
    missing = set()
    for f in sorted(jax_root.rglob("*.py")):
        rel = f.relative_to(jax_root).as_posix()
        port = port_root / rel.replace("ops/pallas/", "ops/kernels/")
        have = _public(port, with_imports=True) if port.exists() else set()
        missing |= {f"{rel}:{n}" for n in _public(f, with_imports=False) - have}
    assert sorted(missing - set(NOT_PORTED)) == []
    assert sorted(set(NOT_PORTED) - missing) == []
