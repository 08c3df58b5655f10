"""The port's predictor and server: a JAX bundle loads into the port and
predicts what the JAX predictor predicts; the HTTP server answers what the
predictor answers. All on the CPU (``device="cpu"``), f32."""

import http.client
import json

import jax
import numpy as np
import pytest

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.evaluation import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.training.checkpoint import save_model_bundle
from dgdm_histopath_torch.deployment.serving import (
    InferenceServer,
    graph_from_json,
    graph_to_json,
)
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor, load_model_checkpoint
from dgdm_histopath_torch.ops.graph import PaddedGraph
from dgdm_histopath_torch.utils.exceptions import InferenceError

CFG = dict(node_features=16, hidden_dims=[32, 16], num_diffusion_steps=3,
           attention_heads=4, graph_layers=2, num_classes=3, compute_dtype="float32")


def _torch_graph(g) -> PaddedGraph:
    import torch
    return PaddedGraph(**{f: torch.from_numpy(np.array(getattr(g, f))) for f in
                          ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")})


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(bundle path, JAX predictor, JAX graphs) for a small f32 model."""
    graphs = [make_synthetic_graph(n_nodes=64, n_real=50, feat_dim=16, seed=s)
              for s in range(3)]
    model = JaxDGDM(**CFG)
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    g0 = jax.tree_util.tree_map(lambda a: a[None], graphs[0])
    params = jax.jit(lambda: model.init(rngs, g0, mode="pretrain", deterministic=True))()
    path = save_model_bundle(tmp_path_factory.mktemp("bundle") / "m.npz", params, CFG)
    return path, JaxPredictor(model=model, params=params, feature_extractor="none"), graphs


@pytest.fixture(scope="module")
def predictor(bundle):
    return DGDMPredictor(model_path=bundle[0], device="cpu")


def test_jax_bundle_predicts_like_the_jax_predictor(bundle, predictor):
    _, jax_pred, graphs = bundle
    with jax.default_matmul_precision("float32"):
        ref = jax_pred.predict_graph(graphs[0])
    out = predictor.predict_graph(_torch_graph(graphs[0]))
    for key in ("logits", "probabilities", "graph_embedding", "attention_weights"):
        np.testing.assert_allclose(out[key], np.asarray(ref[key], np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    assert out["predicted_class"] == ref["predicted_class"]
    assert [b["node_index"] for b in out["biomarkers"][:3]] == \
        [b["node_index"] for b in ref["biomarkers"][:3]]
    assert set(out["uncertainty"]) == set(ref["uncertainty"])


def test_predict_batch_matches_predict_graph(predictor, bundle):
    graphs = [_torch_graph(g) for g in bundle[2]]
    batch = predictor.predict_batch(graphs)
    for g, r in zip(graphs, batch):
        single = predictor.predict_graph(g)
        np.testing.assert_allclose(r["probabilities"], single["probabilities"], atol=1e-5)
        np.testing.assert_allclose(r["attention_weights"], single["attention_weights"],
                                   atol=1e-6)


def test_model_info(predictor):
    info = predictor.get_model_info()
    assert info["num_classes"] == 3 and info["hidden_dims"] == [32, 16]
    assert info["device"] == "cpu" and info["num_parameters"] > 0
    assert info["checkpoint_meta"]["model_config"]["node_features"] == 16


def test_checkpoint_errors(tmp_path, bundle):
    with pytest.raises(InferenceError, match="not found"):
        load_model_checkpoint(tmp_path / "absent.npz", device="cpu")
    data = dict(np.load(bundle[0]))
    data["p:params/pool/surplus"] = np.zeros(2, np.float32)
    bad = tmp_path / "bad.npz"
    np.savez(bad, **data)
    with pytest.raises(InferenceError, match="structure mismatch"):
        load_model_checkpoint(bad, device="cpu")
    with pytest.raises(InferenceError, match="unsupported quant mode"):
        DGDMPredictor(model_path=bundle[0], device="cpu", quant="int4")
    # item 13 is ported: a checkpoint loads for int8 inference, the
    # featurizer it would build computes int8 too
    pred = DGDMPredictor(model_path=bundle[0], device="cpu", quant="int8")
    assert pred.quant == pred.graph_builder.quant == "int8"
    out = pred.predict_graph(_torch_graph(bundle[2][1]))
    assert np.isfinite(out["probabilities"]).all() and out["biomarkers"]


def test_graph_json_round_trip_is_exact(bundle):
    g = _torch_graph(bundle[2][1])
    back = graph_from_json(json.loads(json.dumps(graph_to_json(g))))
    for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask"):
        assert np.array_equal(getattr(back, f).numpy(), getattr(g, f).numpy()), f
        assert getattr(back, f).dtype == getattr(g, f).dtype, f


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_answers_like_the_predictor(predictor, bundle):
    graphs = [_torch_graph(g) for g in bundle[2]]
    server = InferenceServer(predictor, port=0, host="127.0.0.1")
    server.start(background=True)
    try:
        port = server.port
        status, health = _request(port, "GET", "/healthz")
        assert status == 200 and health["healthy"]
        status, info = _request(port, "GET", "/info")
        assert status == 200 and info["num_classes"] == 3
        status, res = _request(port, "POST", "/predict", {"graph": graph_to_json(graphs[0])})
        assert status == 200
        ref = predictor.predict_graph(graphs[0])
        np.testing.assert_array_equal(np.asarray(res["probabilities"], np.float32),
                                      ref["probabilities"])
        assert res["biomarkers"] == ref["biomarkers"]
        status, res = _request(port, "POST", "/predict_batch",
                               {"graphs": [graph_to_json(g) for g in graphs[1:]]})
        assert status == 200 and res["count"] == 2
        for r, b in zip(res["results"], predictor.predict_batch(graphs[1:])):
            np.testing.assert_array_equal(np.asarray(r["probabilities"], np.float32),
                                          b["probabilities"])
        assert _request(port, "POST", "/predict", {"nothing": 1})[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        assert resp.status == 200
        assert "dgdm_requests_total 2\n" in text and "dgdm_errors_total 1\n" in text
        assert server.stats["requests"] == 2 and server.stats["errors"] == 1
    finally:
        server.stop()


def test_server_survives_out_of_range_neighbor_indices(predictor, bundle):
    """A graph whose nbr_idx leaves [0, N) is answered like predict_graph
    answers it (such an index is a zero row), and the next good request is
    still served."""
    good = _torch_graph(bundle[2][0])
    idx = good.nbr_idx.clone()
    idx[0, 0], idx[3, 1], idx[7, 2] = -1, good.num_nodes, 10 ** 6
    bad = good.replace(nbr_idx=idx)
    server = InferenceServer(predictor, port=0, host="127.0.0.1")
    server.start(background=True)
    try:
        status, res = _request(server.port, "POST", "/predict", {"graph": graph_to_json(bad)})
        assert status == 200
        probs = np.asarray(res["probabilities"], np.float32)
        assert np.isfinite(probs).all()
        np.testing.assert_array_equal(probs, predictor.predict_graph(bad)["probabilities"])
        status, res = _request(server.port, "POST", "/predict", {"graph": graph_to_json(good)})
        assert status == 200
        np.testing.assert_array_equal(np.asarray(res["probabilities"], np.float32),
                                      predictor.predict_graph(good)["probabilities"])
        assert server.stats["requests"] == 2 and server.stats["errors"] == 0
    finally:
        server.stop()


def test_server_reads_slides_and_graphs_only_under_data_root(tmp_path, bundle):
    """/predict_slide, /predict with graph_path and /predict_batch with
    graph_paths answer what the predictor answers on the same files; a path
    that leaves data_root, and any path when the server has no data_root,
    is refused (400) and the server goes on serving."""
    from dgdm_histopath_torch.data.graph_io import save_graph
    from dgdm_histopath_torch.models.dgdm import DGDMModel
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.preprocessing import synthetic, tiff

    import torch
    model = DGDMModel(node_features=14, hidden_dims=(32, 16), num_diffusion_steps=3,
                      attention_heads=4, graph_layers=2, num_classes=3, compute_dtype="float32")
    init_parameters(model, torch.Generator().manual_seed(0))
    pred = DGDMPredictor(model=model, device="cpu", feature_extractor="stats", patch_size=32,
                         max_patches=40, tissue_threshold=0.3, node_buckets=[64],
                         decode_workers=1)
    root = tmp_path / "data"
    img, _ = synthetic.generate_tissue_image(512, 512, seed=2)
    slide = tiff.write_tiled_tiff(root / "slides" / "a.tif", synthetic.build_pyramid(img, 3),
                                  tile=128, compression="deflate",
                                  description="Aperio S|AppMag = 20")
    graph = pred.graph_builder.build_graph(pred.processor.process_slide(slide))
    save_graph(graph, root / "graphs" / "a_graph.npz")
    (tmp_path / "outside.npz").write_bytes(b"")
    server = InferenceServer(pred, port=0, host="127.0.0.1", data_root=root)
    plain = InferenceServer(pred, port=0, host="127.0.0.1")
    server.start(background=True)
    plain.start(background=True)
    try:
        status, res = _request(server.port, "POST", "/predict_slide",
                               {"slide_path": "slides/a.tif"})
        assert status == 200
        ref = pred.predict_slide(slide)
        np.testing.assert_array_equal(np.asarray(res["probabilities"], np.float32),
                                      ref["probabilities"])
        assert res["slide_id"] == "a" and res["num_patches"] == 40
        assert res["biomarkers"] == ref["biomarkers"]
        assert set(res["pipeline_timings"]) == set(ref["pipeline_timings"])
        status, res = _request(server.port, "POST", "/predict",
                               {"graph_path": "graphs/a_graph.npz"})
        assert status == 200
        np.testing.assert_array_equal(np.asarray(res["probabilities"], np.float32),
                                      pred.predict_graph(graph)["probabilities"])
        status, res = _request(server.port, "POST", "/predict_batch",
                               {"graph_paths": ["graphs/a_graph.npz"] * 2})
        assert status == 200 and res["count"] == 2
        for bad in ({"slide_path": "../outside.npz"}, {"slide_path": "/etc/hostname"}):
            status, res = _request(server.port, "POST", "/predict_slide", bad)
            assert status == 400 and "escapes data_root" in res["error"]
        status, res = _request(server.port, "POST", "/predict", {"graph_path": "../outside.npz"})
        assert status == 400 and "escapes data_root" in res["error"]
        status, res = _request(plain.port, "POST", "/predict_slide", {"slide_path": "a.tif"})
        assert status == 400 and "without data_root" in res["error"]
        assert _request(server.port, "POST", "/predict_slide", {})[0] == 400
        assert _request(server.port, "GET", "/healthz")[0] == 200
        assert server.stats["requests"] == 3 and server.stats["errors"] == 4
    finally:
        server.stop()
        plain.stop()
