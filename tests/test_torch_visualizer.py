"""The port's AttentionVisualizer and ``dgdm-predict --save-heatmaps``
against the JAX package's. The interactive specs are plain dicts built by the
same numpy code: equal to the JAX dicts, and the HTML/JSON files equal byte
for byte. The matplotlib figures are written as PNG files (their pixels are
not compared). ``--save-heatmaps`` writes the JAX CLI's file names over the
same graphs (both CLIs on the CPU)."""

import contextlib
import io
import logging

import jax
import numpy as np
import pytest

from conftest import make_synthetic_graph
from dgdm_histopath_torch.cli import predict as tpredict
from dgdm_histopath_torch.data import save_graph
from dgdm_histopath_torch.evaluation import visualizer as tv
from dgdm_histopath_tpu.cli import predict as jpredict
from dgdm_histopath_tpu.evaluation import visualizer as jv
from test_torch_training import to_torch_graph


@pytest.fixture(autouse=True, scope="module")
def _package_loggers_put_back():
    """The CLIs call ``setup_logging``, which stops each package's records at
    its own logger; put both loggers back after this file."""
    loggers = [logging.getLogger(n) for n in ("dgdm_histopath_torch", "dgdm_histopath_tpu")]
    saved = [(lg.level, lg.propagate, list(lg.handlers)) for lg in loggers]
    yield
    for lg, (level, propagate, handlers) in zip(loggers, saved):
        lg.setLevel(level)
        lg.propagate = propagate
        lg.handlers[:] = handlers


def _result(seed, classes=3, patches=30):
    rs = np.random.RandomState(seed)
    p = rs.rand(classes)
    p /= p.sum()
    attn = rs.rand(patches).astype(np.float32)
    return {"slide_id": f"slide{seed}", "probabilities": p, "predicted_class": int(p.argmax()),
            "confidence": float(p.max()), "attention_weights": attn / attn.sum(),
            "uncertainty": {"entropy": 0.9, "normalized_entropy": 0.8,
                            "max_probability": float(p.max()), "margin": 0.1},
            "patch_info": [{"x": int(x), "y": int(y)}
                           for x, y in rs.randint(0, 5000, (patches, 2))],
            "biomarkers": [{"rank": i + 1, "attention_score": float(a)}
                           for i, a in enumerate(sorted(attn, reverse=True)[:5])]}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_heatmap_spec_equals_the_jax_spec(seed, masked):
    rs = np.random.RandomState(seed)
    pos, attn = rs.rand(40, 2), rs.rand(40)
    mask = rs.rand(40) < 0.7 if masked else None
    kw = dict(node_mask=mask, title=f"t{seed}")
    assert tv.AttentionVisualizer().attention_heatmap_interactive(pos, attn, **kw) == \
        jv.AttentionVisualizer().attention_heatmap_interactive(pos, attn, **kw)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("names", [None, ["benign", "tumour", "other"]])
def test_prediction_summary_spec_equals_the_jax_spec(seed, names):
    r = _result(seed)
    assert tv.AttentionVisualizer().prediction_summary_interactive(r, class_names=names) == \
        jv.AttentionVisualizer().prediction_summary_interactive(r, class_names=names)
    bare = {k: r[k] for k in ("slide_id", "probabilities")}
    assert tv.AttentionVisualizer().prediction_summary_interactive(bare) == \
        jv.AttentionVisualizer().prediction_summary_interactive(bare)


@pytest.mark.parametrize("suffix", [".html", ".json"])
def test_saved_interactive_files_equal_the_jax_files(tmp_path, suffix):
    spec = tv.AttentionVisualizer().prediction_summary_interactive(_result(3))
    ours = tv.save_interactive(spec, tmp_path / "port" / f"s{suffix}")
    theirs = jv.save_interactive(spec, tmp_path / "jax" / f"s{suffix}")
    assert ours.read_bytes() == theirs.read_bytes()


def test_figures_need_plotly_only_as_figure_objects():
    spec = tv.AttentionVisualizer().attention_heatmap_interactive(np.zeros((2, 2)), np.ones(2))
    if tv.PLOTLY_AVAILABLE:
        assert tv.to_plotly_figure(spec) is not None
    else:
        with pytest.raises(ImportError, match="plotly"):
            tv.to_plotly_figure(spec)


def test_matplotlib_figures_are_written(tmp_path):
    viz = tv.AttentionVisualizer(dpi=40)
    r = _result(4)
    rs = np.random.RandomState(4)
    g = make_synthetic_graph(n_nodes=32, n_real=20, feat_dim=4, seed=4)
    pos, mask = np.asarray(g.pos), np.asarray(g.node_mask)
    written = [
        viz.prediction_summary(r, class_names=["a", "b", "c"], save_path=tmp_path / "sum.png"),
        viz.attention_heatmap(pos, rs.rand(32), node_mask=mask, save_path=tmp_path / "heat.png"),
        viz.render_graph(pos, np.asarray(g.nbr_idx), np.asarray(g.nbr_mask), node_mask=mask,
                         node_values=rs.rand(32), save_path=tmp_path / "graph.png"),
        viz.biomarker_chart(r["biomarkers"], save_path=tmp_path / "bio.png"),
        viz.uncertainty_plot([r["uncertainty"]] * 3, save_path=tmp_path / "unc.png"),
    ]
    for path in written:
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", path


@pytest.fixture(scope="module")
def heatmap_runs(tmp_path_factory):
    """Both predict CLIs with ``--save-heatmaps`` over the same two graph
    files and one JAX bundle."""
    from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
    from dgdm_histopath_tpu.training.checkpoint import save_model_bundle

    root = tmp_path_factory.mktemp("heatmaps")
    cfg = dict(node_features=8, hidden_dims=[16, 8], num_diffusion_steps=2,
               attention_heads=4, graph_layers=1, num_classes=2, compute_dtype="float32",
               use_hierarchical=False)
    graphs = [make_synthetic_graph(n_nodes=32, n_real=24, feat_dim=8, seed=s) for s in (0, 1)]
    for i, g in enumerate(graphs):
        save_graph(to_torch_graph(g), root / "graphs" / f"case{i}_graph.npz")
    model = JaxDGDM(**cfg)
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    params = model.init(rngs, jax.tree_util.tree_map(lambda a: a[None], graphs[0]),
                        mode="pretrain", deterministic=True)
    bundle = save_model_bundle(root / "m.npz", params, cfg)
    argv = ["--model", str(bundle), "--input", str(root / "graphs"), "--save-heatmaps",
            "--class-names", "benign,tumour", "--log-level", "WARNING"]
    with contextlib.redirect_stderr(io.StringIO()):
        rc_jax = jpredict.main(argv + ["--output-dir", str(root / "jax")])
        rc_port = tpredict.main(argv + ["--output-dir", str(root / "port"), "--device", "cpu"])
    return root, rc_jax, rc_port


def test_save_heatmaps_writes_the_jax_file_names(heatmap_runs):
    root, rc_jax, rc_port = heatmap_runs
    assert rc_jax == 0 and rc_port == 0
    names = sorted(p.name for p in (root / "port").iterdir())
    assert names == sorted(p.name for p in (root / "jax").iterdir())
    assert names == ["case0_graph.json", "case0_graph_summary.html", "case0_graph_summary.png",
                     "case1_graph.json", "case1_graph_summary.html", "case1_graph_summary.png"]


def test_save_heatmaps_html_names_the_classes(heatmap_runs):
    root = heatmap_runs[0]
    for i in range(2):
        html = (root / "port" / f"case{i}_graph_summary.html").read_text()
        assert '"x": ["benign", "tumour"]' in html
        assert (root / "port" / f"case{i}_graph_summary.png").read_bytes()[:4] == b"\x89PNG"
