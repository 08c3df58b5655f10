"""The port's slide path (``TissueGraphBuilder``, ``DGDMPredictor.predict_slide``
and ``predict_slides``, ``graph_io``) against the JAX package's, on the CPU,
on synthetic slides and a small f32 model with the JAX model's weights.

Tolerances: graphs built from the same SlideData have equal neighbour lists
slot for slot, and x and edge_attr within 1e-5; predictions within 1e-4 in
probability with the same biomarker ranking (with the ``"stats"`` featurizer
the features differ through Macenko by up to 1e-4 of their scale, see
``tests/test_torch_vit.py``); pipelined and serial runs of the port equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.data import graph_io as jgio
from dgdm_histopath_tpu.evaluation import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops import graph as jgraph
from dgdm_histopath_tpu.preprocessing import synthetic as jsyn
from dgdm_histopath_tpu.preprocessing.slide_processor import SlideProcessor as JaxProcessor
from dgdm_histopath_tpu.preprocessing.tissue_graph_builder import (
    TissueGraphBuilder as JaxBuilder,
)
from dgdm_histopath_torch.convert import encoder_params_from_flax, load_state
from dgdm_histopath_torch.data import graph_io
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.ops import graph
from dgdm_histopath_torch.preprocessing import synthetic
from dgdm_histopath_torch.preprocessing.slide_processor import PatchInfo, SlideData
from dgdm_histopath_torch.preprocessing.tiff import write_tiled_tiff
from dgdm_histopath_torch.preprocessing.tissue_graph_builder import TissueGraphBuilder
from dgdm_histopath_torch.utils.exceptions import GraphConstructionError
from dgdm_histopath_torch.utils.optimization import PrefetchIterator

REPO = Path(__file__).resolve().parents[1]
SLIDE_KW = dict(patch_size=32, max_patches=30, tissue_threshold=0.3, node_buckets=[32, 64])


def _port_slide_data(sd) -> SlideData:
    return SlideData(sd.slide_id, sd.slide_path, sd.patches,
                     [PatchInfo(**vars(p)) for p in sd.patch_info], dict(sd.metadata),
                     sd.tissue_mask)


@pytest.fixture(scope="module")
def slide_data():
    backend, _ = jsyn.synthetic_slide(1024, 1024, num_levels=3, seed=2)
    return JaxProcessor(patch_size=64, max_patches=200, tissue_threshold=0.5,
                        stain_normalize=False).process_slide(backend, slide_id="g")


def _jax_graph_arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in ("x", "pos", "nbr_idx", "nbr_mask",
                                                   "edge_attr", "node_mask")}


@pytest.mark.parametrize("features", ["given", "placeholder"])
@pytest.mark.parametrize("sort,window", [(False, None), (True, None), (True, 32)])
def test_build_graph_matches_jax(slide_data, features, sort, window):
    n = slide_data.num_patches
    feats = (np.random.RandomState(0).randn(n, 24).astype(np.float32)
             if features == "given" else None)
    kw = dict(feature_extractor="none" if features == "placeholder" else "stats",
              node_buckets=[64, 128, 256], spatial_sort=sort, knn_window=window)
    sd = slide_data
    if features == "placeholder":
        sd = SlideData(sd.slide_id, sd.slide_path, sd.patches[:0], sd.patch_info,
                       sd.metadata, sd.tissue_mask)
    with jax.default_matmul_precision("float32"):
        ref = _jax_graph_arrays(JaxBuilder(**kw).build_graph(sd, features=feats))
    out = TissueGraphBuilder(**kw, device="cpu").build_graph(_port_slide_data(sd),
                                                            features=feats)
    assert out.x.shape == ref["x"].shape and out.nbr_idx.shape[-1] == 24
    for f in ("nbr_idx", "nbr_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f], err_msg=f)
    for f in ("x", "pos", "edge_attr"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f], atol=1e-5, rtol=0,
                                   err_msg=f)
    if window:
        assert graph.in_band_fraction(out.nbr_idx, out.nbr_mask, window) == 1.0


def test_subsampling_bucket_and_coarsening_match_jax(slide_data):
    feats = np.random.RandomState(1).randn(slide_data.num_patches, 16).astype(np.float32)
    kw = dict(feature_extractor="stats", node_buckets=[64], per_slide_feature_norm=True)
    jb, tb = JaxBuilder(**kw), TissueGraphBuilder(**kw, device="cpu")
    with jax.default_matmul_precision("float32"):
        jg = jb.build_graph(slide_data, features=feats, label=1)
        ref = [_jax_graph_arrays(g) for g in [jg, jb.coarsen_graph(jg, 0.5)]]
    tg = tb.build_graph(_port_slide_data(slide_data), features=feats, label=1)
    out = [tg, tb.coarsen_graph(tg, 0.5)]
    assert int(tg.y) == 1 and tg.node_mask.all()
    for o, r in zip(out, ref):
        for f in ("nbr_idx", "nbr_mask", "node_mask"):
            np.testing.assert_array_equal(getattr(o, f).numpy(), r[f], err_msg=f)
        np.testing.assert_allclose(o.edge_attr.numpy(), r["edge_attr"], atol=1e-5, rtol=0)
    assert len(tb.build_hierarchical_graphs(_port_slide_data(slide_data), levels=3,
                                            features=feats)) == 3
    empty = SlideData("e", "", np.zeros((0, 8, 8, 3), np.uint8), [], {})
    with pytest.raises(GraphConstructionError, match="no patches"):
        tb.build_graph(empty)


def _models(node_features):
    cfg = dict(node_features=node_features, hidden_dims=(32, 16), num_diffusion_steps=4,
               attention_heads=4, graph_layers=2, num_classes=3, use_hierarchical=False,
               compute_dtype="float32")
    jm = JaxDGDM(**cfg)
    g = make_synthetic_graph(n_nodes=32, n_real=20, feat_dim=node_features)
    batched = jax.tree_util.tree_map(lambda a: a[None] if hasattr(a, "ndim") else a, g)
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    params = jm.init(rngs, batched, mode="pretrain", deterministic=True)
    tm = DGDMModel(**cfg)
    load_state(tm, encoder_params_from_flax(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def stats_pair():
    jm, params, tm = _models(14)
    kw = dict(SLIDE_KW, feature_extractor="stats", stain_normalize=True)
    return JaxPredictor(model=jm, params=params, **kw), DGDMPredictor(
        model=tm, device="cpu", decode_workers=1, **kw)


@pytest.mark.parametrize("extractor", ["none", "stats"])
def test_predict_slide_matches_jax(extractor, stats_pair):
    if extractor == "stats":
        jp, tp = stats_pair
    else:
        jm, params, tm = _models(5)
        kw = dict(SLIDE_KW, feature_extractor="none", stain_normalize=False)
        jp = JaxPredictor(model=jm, params=params, **kw)
        tp = DGDMPredictor(model=tm, device="cpu", **kw)
    with jax.default_matmul_precision("float32"):
        ref = jp.predict_slide(jsyn.synthetic_slide(512, 512, num_levels=3, seed=5)[0],
                               slide_id="e2e")
    out = tp.predict_slide(synthetic.synthetic_slide(512, 512, num_levels=3, seed=5)[0],
                           slide_id="e2e")
    assert out["slide_id"] == "e2e" and out["num_patches"] == ref["num_patches"] == 30
    assert out["patch_info"] == ref["patch_info"]
    np.testing.assert_allclose(out["probabilities"], ref["probabilities"], atol=1e-4, rtol=0)
    assert out["predicted_class"] == ref["predicted_class"]
    assert [b["node_index"] for b in out["biomarkers"]] == \
        [b["node_index"] for b in ref["biomarkers"]]
    assert set(out.get("pipeline_timings", {})) == set(ref.get("pipeline_timings", {}))


def test_pipelined_and_serial_agree_and_time_every_stage(stats_pair):
    _, tp = stats_pair
    backend = synthetic.synthetic_slide(512, 512, num_levels=3, seed=6)[0]
    piped = tp.predict_slide(backend, slide_id="s")
    serial = tp.predict_slide(backend, slide_id="s", pipelined=False)
    np.testing.assert_array_equal(piped["probabilities"], serial["probabilities"])
    np.testing.assert_array_equal(piped["attention_weights"], serial["attention_weights"])
    timings = piped["pipeline_timings"]
    assert set(timings) == {"tissue_mask_s", "decode_s", "featurize_s", "graph_s",
                            "forward_s", "total_s"}
    assert all(v >= 0 for v in timings.values()) and "pipeline_timings" not in serial


def _write_slides(tmp_path, seeds):
    paths = []
    for s in seeds:
        img, _ = synthetic.generate_tissue_image(512, 512, seed=s)
        paths.append(write_tiled_tiff(tmp_path / f"slide{s}.tif", synthetic.build_pyramid(img, 3),
                                      tile=128, compression="deflate",
                                      description="Aperio S|AppMag = 20"))
    return paths


def test_predict_slides_match_predict_slide(tmp_path, stats_pair):
    _, tp = stats_pair
    paths = _write_slides(tmp_path, (11, 12))
    single = [tp.predict_slide(p) for p in paths]
    for pipelined in (True, False):
        many = tp.predict_slides(paths, pipelined=pipelined)
        assert [r["slide_id"] for r in many] == ["slide11", "slide12"]
        for a, b in zip(many, single):
            np.testing.assert_array_equal(a["probabilities"], b["probabilities"])
    assert tp.predict_slides([]) == []


def test_decode_workers_give_the_same_prediction(tmp_path):
    jm, params, tm = _models(14)
    kw = dict(SLIDE_KW, feature_extractor="stats", max_patches=64)
    path = _write_slides(tmp_path, (13,))[0]
    inline = DGDMPredictor(model=tm, device="cpu", decode_workers=1, **kw).predict_slide(path)
    pred = DGDMPredictor(model=tm, device="cpu", decode_workers=2, **kw)
    try:
        pooled = pred.predict_slide(path)
        assert pred._pool and pred._pool_workers == 2
    finally:
        pred.close()
    assert pred._pool is None
    np.testing.assert_array_equal(pooled["probabilities"], inline["probabilities"])


def test_windowed_model_gets_band_built_graphs():
    tm = DGDMModel(node_features=5, hidden_dims=(32, 16), num_diffusion_steps=4,
                   attention_heads=4, graph_layers=2, num_classes=3, use_hierarchical=False,
                   compute_dtype="float32", spatial_window=8, graph_window=8)
    pred = DGDMPredictor(model=tm, device="cpu", feature_extractor="none",
                         stain_normalize=False, **SLIDE_KW)
    assert pred.graph_builder.spatial_sort and pred.graph_builder.knn_window == 8
    backend = synthetic.synthetic_slide(512, 512, num_levels=3, seed=5)[0]
    assert pred.predict_slide(backend)["probabilities"].shape == (3,)
    built = pred.graph_builder.build_graph(pred.processor.process_slide(backend))
    assert graph.in_band_fraction(built.nbr_idx, built.nbr_mask, 8) == 1.0


def test_graph_io_round_trip_and_jax_files(tmp_path):
    g = TissueGraphBuilder(feature_extractor="none", node_buckets=[64], device="cpu").build_graph(
        SlideData("s", "", np.zeros((0, 8, 8, 3), np.uint8),
                  [PatchInfo(x, y, 0, 20.0, 32, 1.0) for x in range(0, 320, 32)
                   for y in (0, 32, 64)], {"dimensions": [512, 512]}), label=2)
    back = graph_io.load_graph(graph_io.save_graph(g, tmp_path / "a" / "g_graph.npz"))
    for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y"):
        assert torch.equal(getattr(back, f), getattr(g, f)), f
    jg = make_synthetic_graph(n_nodes=32, n_real=20, feat_dim=8, num_classes=3)
    from_jax = graph_io.load_graph(jgio.save_graph(jg, tmp_path / "j.npz"))
    for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y"):
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(), np.asarray(getattr(jg, f)))
    with pytest.raises(Exception, match="unsupported graph format"):
        graph_io.load_graph(tmp_path / "g.txt")


@pytest.mark.parametrize("with_attr", [True, False])
def test_from_edge_index_matches_jax(with_attr):
    rs = np.random.RandomState(0)
    x = rs.randn(12, 4).astype(np.float32)
    ei = rs.randint(0, 12, (2, 70))
    attr = rs.rand(70, 2).astype(np.float32) if with_attr else None
    out = graph.from_edge_index(x, ei, edge_attr=attr, max_neighbors=5, bucket=16)
    ref = jgraph.from_edge_index(x, ei, edge_attr=attr, max_neighbors=5, bucket=16)
    for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), f)


def test_prefetch_iterator_hands_on_errors_and_stops_early():
    def items():
        yield 1
        yield 2
        raise ValueError("boom")
    it = PrefetchIterator(items(), depth=1)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)
    endless = PrefetchIterator(iter(int, 1), depth=2)    # never ends by itself
    assert next(endless) == 0
    endless.close()
    assert not endless._thread.is_alive()


def test_predict_slide_runs_with_jax_blocked():
    """The slide path (TIFF written and read, mask, grid, featurizer, kNN,
    forward) with jax, flax and the JAX package unimportable."""
    code = (
        "import sys, tempfile\n"
        "for m in ('jax', 'flax', 'dgdm_histopath_tpu'): sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "from dgdm_histopath_torch import DGDMPredictor, create_model\n"
        "from dgdm_histopath_torch.deployment.serving import InferenceServer\n"
        "from dgdm_histopath_torch.preprocessing import synthetic, tiff\n"
        "img, _ = synthetic.generate_tissue_image(512, 512, seed=1)\n"
        "d = Path(tempfile.mkdtemp())\n"
        "p = tiff.write_tiled_tiff(d / 's.tif', synthetic.build_pyramid(img, 3), tile=128,"
        " compression='deflate', description='Aperio S|AppMag = 20')\n"
        "m = create_model('dgdm-small', num_classes=2, device='cpu', node_features=14,"
        " hidden_dims=(16, 8), compute_dtype='float32')\n"
        "pred = DGDMPredictor(model=m, device='cpu', feature_extractor='stats', patch_size=32,"
        " max_patches=40, tissue_threshold=0.3, node_buckets=[64], decode_workers=1)\n"
        "r = pred.predict_slide(p)\n"
        "assert r['num_patches'] == 40 and abs(r['probabilities'].sum() - 1) < 1e-5\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_predictor_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DGDMPredictor(model=_models(5)[2], feature_extractor="none")
