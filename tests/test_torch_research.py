"""Parity of the port's ``research/`` with the JAX package's, on the CPU.

The sizes are those of tests/test_research.py: a DGDM model of 16-d
features, hidden (32, 16), 4 heads and one graph layer (f32) on two graphs of
24 nodes with 20 real ones; the fusion modules at 16 wide. Each JAX module
is initialised once (module fixtures), its parameters load strictly into the
port's module through ``convert.params_from_flax``, and the same seeded
numpy inputs go through both (the JAX side at
``default_matmul_precision("float32")``).

Tolerances: module outputs 1e-5; the feature gradients of saliency,
integrated gradients and the attacks within 1e-4 of the tensor's largest
entry (f32 sums in other orders through the model). FGSM and PGD take
sign(g), which flips where |g| is at rounding level: the adversarial
features are compared where |g| exceeds 1e-3 of max|g| (FGSM), and for PGD
(no random start; each step's sign is its own gradient's) where the first
step's |g| exceeds 5e-2 of its largest entry, with at least 95% of all
entries equal. The statistics, the runner's JSONL and the reports are host
numpy and equal to the JAX package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgdm_histopath_torch.research as tres
from conftest import make_synthetic_graph
from dgdm_histopath_tpu import research as jres
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import init_parameters
from test_torch_model import _flat, to_torch_graph

MODEL = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
             attention_heads=4, graph_layers=1, num_classes=2, use_hierarchical=False,
             use_spatial_attention=False, compute_dtype="float32")
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2)}
LABELS = [0, 1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol=1e-5):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _load(module, params):
    load_state(module, params_from_flax(_flat(params)))
    return module.eval()


def _jax(fn):
    with jax.default_matmul_precision("float32"):
        return fn()


def _same(a, b) -> bool:
    """Equal, NaN included."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def dgdm():
    """(JAX model, params, JAX batch, port model, port batch)."""
    batch = j_batch([make_synthetic_graph(seed=i, n_nodes=24, n_real=20, feat_dim=16)
                     for i in range(2)])
    jm = JaxDGDM(**MODEL, gather_impl="xla")
    params = _jax(lambda: jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain",
                                                    deterministic=True))(batch))
    tm = DGDMModel(**MODEL)
    load_state(tm, params_from_flax(_flat(params)))
    return jm, params, batch, tm.eval(), to_torch_graph(batch)


@pytest.fixture(scope="module")
def feature_grads(dgdm):
    """The class-0 score's and the attack loss's gradients, both packages."""
    jm, params, jb, tm, tb = dgdm
    jsal = jres.ClinicalSaliencyAnalyzer(jm, params)
    tsal = tres.ClinicalSaliencyAnalyzer(tm)
    jatk = jres.MedicalAdversarialAttack(jm, params, epsilon=0.1, pgd_steps=3)
    tatk = tres.MedicalAdversarialAttack(tm, epsilon=0.1, pgd_steps=3)
    labels = jnp.asarray(LABELS)
    with jax.default_matmul_precision("float32"):
        j_score = np.asarray(jsal._grad(jb.x, jb, 0))
        j_loss = np.asarray(jax.grad(jres.adversarial_robustness._loss_fn(
            jm, params, jb, labels))(jb.x))
    t_score = tsal.class_score_grad(tb.x, tb, 0).numpy()
    t_loss = tres.adversarial_robustness.feature_grad(
        tatk.loss_fn(tb, torch.tensor(LABELS)), tb.x).numpy()
    return dict(j_score=j_score, t_score=t_score, j_loss=j_loss, t_loss=t_loss,
                jsal=jsal, tsal=tsal, jatk=jatk, tatk=tatk)


@pytest.mark.parametrize("which", ["score", "loss"])
def test_feature_gradients_match_jax(feature_grads, which):
    """∂/∂x of the class score (saliency) and of the attack loss; no
    parameter of the port's model gets a .grad."""
    g = feature_grads
    assert _rel(g[f"t_{which}"], g[f"j_{which}"]) < 1e-4
    assert np.abs(g[f"j_{which}"]).max() > 0
    assert all(p.grad is None for p in g["tsal"].model.parameters())


def test_node_saliency_matches_jax(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    ref = feature_grads["jsal"].node_saliency(jb, class_idx=0)
    out = feature_grads["tsal"].node_saliency(tb, class_idx=0)
    assert out.shape == (2, 24)
    assert _rel(out, ref) < 1e-4
    assert out[~np.asarray(jb.node_mask)].max() == 0.0
    # the default class is the first graph's prediction, as in JAX
    ref_default = feature_grads["jsal"].node_saliency(jb)
    assert _rel(feature_grads["tsal"].node_saliency(tb), ref_default) < 1e-4


def test_integrated_gradients_match_jax(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    with jax.default_matmul_precision("float32"):
        ref = feature_grads["jsal"].integrated_gradients(jb, class_idx=1, steps=16)
    out = feature_grads["tsal"].integrated_gradients(tb, class_idx=1, steps=16)
    assert _rel(out, ref) < 1e-4
    assert out[~np.asarray(jb.node_mask)].max() == 0.0


def test_fgsm_matches_jax_where_the_sign_is_defined(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(feature_grads["jatk"].fgsm(jb, jnp.asarray(LABELS)).x)
    out = feature_grads["tatk"].fgsm(tb, torch.tensor(LABELS)).x.numpy()
    g = feature_grads["j_loss"]
    sure = np.abs(g) > 1e-3 * np.abs(g).max()
    np.testing.assert_array_equal(out[sure], ref[sure])
    delta = np.abs(out - np.asarray(jb.x))
    assert delta.max() <= 0.1 + 1e-6
    assert delta[~np.asarray(jb.node_mask)].max() == 0.0


def test_pgd_matches_jax_without_random_start(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(feature_grads["jatk"].pgd(jb, jnp.asarray(LABELS)).x)
    out = feature_grads["tatk"].pgd(tb, torch.tensor(LABELS)).x.numpy()
    g = feature_grads["j_loss"]
    sure = np.abs(g) > 5e-2 * np.abs(g).max()
    np.testing.assert_allclose(out[sure], ref[sure], rtol=0, atol=1e-6)
    assert np.mean(np.abs(out - ref) <= 1e-6) >= 0.95
    x0 = np.asarray(jb.x)
    assert np.abs(out - x0).max() <= 0.1 + 1e-6
    assert np.abs(out - x0)[~np.asarray(jb.node_mask)].max() == 0.0


def test_pgd_random_start_stays_in_the_ball(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    gen = torch.Generator().manual_seed(3)
    out = feature_grads["tatk"].attack(tb, LABELS, method="pgd", generator=gen).x
    delta = (out - tb.x).abs()
    assert float(delta.max()) <= 0.1 + 1e-6
    assert float(delta[~tb.node_mask].max()) == 0.0
    with pytest.raises(ValueError, match="unknown attack"):
        feature_grads["tatk"].attack(tb, LABELS, method="cw")


@pytest.mark.parametrize("levels", [0, 8])
def test_defense_without_noise_matches_jax(dgdm, levels):
    """Neighbourhood smoothing, with and without quantization to 8 levels."""
    _, _, jb, _, tb = dgdm
    jd = jres.ClinicalAdversarialDefense(smoothing_weight=0.5, quantization_levels=levels)
    td = tres.ClinicalAdversarialDefense(smoothing_weight=0.5, quantization_levels=levels)
    ref = np.asarray(jd.defend(jb).x)
    out = td.defend(tb).x.numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert not np.allclose(out, np.asarray(jb.x))
    # noise is drawn only with a generator, and never on padding
    noisy = tres.ClinicalAdversarialDefense(0.0, noise_sigma=0.1).defend(
        tb, torch.Generator().manual_seed(0)).x
    assert torch.equal(noisy[~tb.node_mask], tb.x[~tb.node_mask])
    assert not torch.equal(noisy, tb.x)


def test_robustness_analyzer_fgsm_matches_jax(dgdm):
    jm, params, jb, tm, tb = dgdm
    defense = dict(smoothing_weight=0.5)
    with jax.default_matmul_precision("float32"):
        ref = jres.RobustnessAnalyzer(jm, params).analyze(
            jb, LABELS, jres.MedicalAdversarialAttack(jm, params, epsilon=0.1),
            defense=jres.ClinicalAdversarialDefense(**defense), methods=("fgsm",))
    out = tres.RobustnessAnalyzer(tm).analyze(
        tb, LABELS, tres.MedicalAdversarialAttack(tm, epsilon=0.1),
        defense=tres.ClinicalAdversarialDefense(**defense), methods=("fgsm", "pgd"))
    assert set(out["attacks"]) == {"fgsm", "pgd"}
    for key in ("clean_accuracy", "clean_confidence"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5)
    for key, value in ref["attacks"]["fgsm"].items():
        np.testing.assert_allclose(out["attacks"]["fgsm"][key], value, rtol=1e-5)


def test_weights_load_through_the_jax_style_argument(dgdm):
    """(model, state dict) binds the weights strictly, as (model, params)."""
    _, _, _, tm, tb = dgdm
    fresh = init_parameters(DGDMModel(**MODEL), torch.Generator().manual_seed(9))
    analyzer = tres.ClinicalSaliencyAnalyzer(fresh, tm.state_dict())
    a = analyzer.node_saliency(tb, class_idx=0)
    b = tres.ClinicalSaliencyAnalyzer(tm).node_saliency(tb, class_idx=0)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(Exception, match="mismatch"):
        tres.RobustnessAnalyzer(DGDMModel(**MODEL), {"nope": torch.zeros(1)})


# ---------------------------------------------------------------------------
# experimental graph modules and multimodal fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph16():
    return j_batch([make_synthetic_graph(seed=i, n_nodes=16, n_real=12, feat_dim=16)
                    for i in range(2)])


@pytest.mark.parametrize("in_features", [16, 24])
def test_phase_modulated_diffusion_matches_jax(graph16, in_features):
    g = graph16
    x = np.random.RandomState(in_features).randn(2, 16, in_features).astype(np.float32)
    jm = jres.PhaseModulatedGraphDiffusion(features=16, num_rounds=2)
    args = (x, g.nbr_idx, g.nbr_mask, g.node_mask)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), *args))
    ref = _jax(lambda: jm.apply(params, *args))
    tm = _load(tres.PhaseModulatedGraphDiffusion(16, num_rounds=2, in_features=in_features),
               params)
    out = tm(_t(x), _t(g.nbr_idx), _t(g.nbr_mask), _t(g.node_mask))
    _close(out, ref)
    assert tres.QuantumGraphDiffusion is tres.PhaseModulatedGraphDiffusion


def test_phase_modulated_diffusion_draws_its_phases():
    m = init_parameters(tres.PhaseModulatedGraphDiffusion(64, num_rounds=2),
                        torch.Generator().manual_seed(0))
    for r in range(2):
        p = getattr(m, f"phase{r}")
        assert p.shape == (32,) and float(p.detach().min()) >= 0.0 and float(p.detach().max()) < 0.1


def test_hierarchical_attention_fusion_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16).astype(np.float32)
    mask = np.ones((2, 16), bool)
    mask[1, 12:] = False
    jm = jres.HierarchicalAttentionFusion(features=16, num_heads=4)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), [x, x * 0.5], mask))
    ref = _jax(lambda: jm.apply(params, [x, x * 0.5], mask))
    tm = _load(tres.HierarchicalAttentionFusion(16, num_heads=4), params)
    _close(tm([_t(x), _t(x) * 0.5], _t(mask)), ref)


def test_adaptive_graph_topology_matches_jax(graph16):
    g = graph16
    jm = jres.AdaptiveGraphTopology(features=16)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), g.x, g.nbr_idx, g.nbr_mask))
    ref = _jax(lambda: jm.apply(params, g.x, g.nbr_idx, g.nbr_mask))
    tm = _load(tres.AdaptiveGraphTopology(16, 16), params)
    out = tm(_t(g.x), _t(g.nbr_idx), _t(g.nbr_mask))
    _close(out["scores"], ref["scores"])
    _close(out["edge_weights"], ref["edge_weights"])
    np.testing.assert_array_equal(out["nbr_mask"].numpy(), np.asarray(ref["nbr_mask"]))


@pytest.fixture(scope="module")
def modality_tokens():
    """The JAX encoder's tokens [4, 2, 16] and its inputs, both packages."""
    rs = np.random.RandomState(0)
    inputs = {"histology": rs.randn(4, 32).astype(np.float32),
              "genomic": rs.randn(4, 48).astype(np.float32)}
    present = {"genomic": np.array([True, True, False, True])}
    enc = jres.AdaptiveModalityEncoder({"histology": 32, "genomic": 48}, embed_dim=16)
    params = _jax(lambda: enc.init(jax.random.PRNGKey(0), inputs, present))
    toks = _jax(lambda: enc.apply(params, inputs, present))
    return inputs, present, params, np.asarray(toks)


def test_adaptive_modality_encoder_matches_jax(modality_tokens):
    inputs, present, params, ref = modality_tokens
    tm = _load(tres.AdaptiveModalityEncoder({"histology": 32, "genomic": 48},
                                            embed_dim=16), params)
    out = tm({k: _t(v) for k, v in inputs.items()}, {k: _t(v) for k, v in present.items()})
    assert out.shape == (4, 2, 16)
    _close(out, ref)
    # the missing modality is the learned null embedding
    _close(out[2, 0], np.asarray(params["params"]["genomic_null"]))


@pytest.mark.parametrize("fuser", ["cross_attention", "uncertainty", "hierarchical"])
def test_fusion_modules_match_jax(modality_tokens, fuser):
    toks = modality_tokens[3]
    mask = np.array([[True, True], [True, False], [True, True], [False, True]])
    if fuser == "cross_attention":
        jm = jres.CrossModalAttentionFusion(16, num_heads=4, num_layers=2)
        args = (toks[:, 0], toks, mask)
        tm = tres.CrossModalAttentionFusion(16, num_heads=4, num_layers=2)
    elif fuser == "uncertainty":
        jm, args, tm = jres.UncertaintyAwareFusion(16), (toks, mask), tres.UncertaintyAwareFusion(16)
    else:
        groups = {"b": [1], "a": [0, 1]}
        jm = jres.HierarchicalModalityFusion(groups, embed_dim=16, num_heads=4)
        args, tm = (toks,), tres.HierarchicalModalityFusion(groups, embed_dim=16, num_heads=4)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(1), *args))
    ref = _jax(lambda: jm.apply(params, *args))
    out = _load(tm, params)(*[_t(a) for a in args])
    if fuser == "uncertainty":
        for key in ("fused", "weights", "log_var"):
            _close(out[key], ref[key])
        np.testing.assert_allclose(out["weights"].detach().sum(-1).numpy(), 1.0, atol=1e-6)
    else:
        _close(out, ref)


def test_benchmark_fusion_strategies_replays_jax(monkeypatch):
    """The port's benchmark on the JAX run's data and initial parameters:
    the losses before and after 20 Adam steps within 1e-5 of JAX's."""
    batch, e = 2, 16
    rng = jax.random.PRNGKey(7)
    ref = jres.benchmark_fusion_strategies(rng, batch=batch, embed_dim=e)
    # the JAX function's own draws, replayed (research/multimodal_fusion.py:158-195)
    r1, r2, r3 = jax.random.split(rng, 3)
    latent = jax.random.normal(r1, (batch * 16, e))
    inputs = {"histology": latent + 0.1 * jax.random.normal(r2, latent.shape),
              "genomic": latent @ jax.random.normal(r3, (e, e)) * 0.1}
    y = np.asarray(jnp.sum(latent, axis=-1) > 0).astype(np.int64)
    enc = jres.AdaptiveModalityEncoder({"histology": e, "genomic": e}, embed_dim=e)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    enc_p = enc.init(k1, inputs)
    toks = enc.apply(enc_p, inputs)
    head = np.asarray(jax.random.normal(k3, (e, 2)) * 0.1)
    init = {}
    for name, jf, tf in [
            ("cross_attention", jres.CrossModalAttentionFusion(e, num_heads=4, num_layers=1),
             tres.CrossModalAttentionFusion(e, num_heads=4, num_layers=1)),
            ("uncertainty", jres.UncertaintyAwareFusion(e), tres.UncertaintyAwareFusion(e))]:
        fp = jf.init(k2, toks[:, 0], toks) if name == "cross_attention" else jf.init(k2, toks)
        te = _load(tres.AdaptiveModalityEncoder({"histology": e, "genomic": e},
                                                embed_dim=e), enc_p)
        init[name] = (te.state_dict(), _load(tf, fp).state_dict(), head)
    out = tres.benchmark_fusion_strategies(batch=batch, embed_dim=e, device="cpu",
                                           data=({k: np.asarray(v) for k, v in inputs.items()},
                                                 y), init=init)
    for name in ("cross_attention", "uncertainty"):
        for key in ("initial_loss", "final_loss"):
            np.testing.assert_allclose(out[name][key], ref[name][key], rtol=1e-5)
        assert out[name]["final_loss"] < out[name]["initial_loss"]


# ---------------------------------------------------------------------------
# host-side: statistics, experiments, summaries and reports
# ---------------------------------------------------------------------------

def _scores():
    rs = np.random.RandomState(2)
    return rs.rand(40) + 0.3, rs.rand(40)


@pytest.mark.parametrize("fn", ["paired_t_test", "wilcoxon_signed_rank", "cohens_d",
                                "bootstrap_diff_ci"])
def test_statistics_match_jax(fn):
    a, b = _scores()
    for x, y in ((a, b), (a[:2], a[:2])):             # the second: too few samples, NaNs
        assert _same(getattr(tres, fn)(x, y), getattr(jres, fn)(x, y))


def test_validator_comparator_and_suite_match_jax():
    a, b = _scores()
    scores = {"m1": a, "m2": b, "m0": (a + b) / 2}
    assert tres.ModelComparator().compare_all(scores) == jres.ModelComparator().compare_all(scores)
    assert (tres.StatisticalValidator(0.01).compare(a, b, "x", "y")
            == jres.StatisticalValidator(0.01).compare(a, b, "x", "y"))
    tables = []
    for pkg in (tres, jres):
        suite = pkg.BenchmarkSuite()
        suite.register_model("good", lambda ds: {"metrics": {"auc": float(np.mean(ds))}})
        suite.register_model("bad", lambda ds: 1 / 0)
        suite.register_dataset("d", a)
        suite.run()
        tables.append(suite.table("auc"))
    assert tables[0] == tables[1] == {"good": {"d": float(np.mean(a))}}


def _experiment(params, seed):
    if params.get("lr") == 0.1 and seed == 1:
        raise RuntimeError("diverged")
    rs = np.random.RandomState(seed)
    return {"auc": 0.8 + params["lr"] * 10 + rs.rand() * 0.01}


def test_runner_jsonl_analysis_and_table_match_jax(tmp_path):
    out = {}
    for name, pkg in (("torch", tres), ("jax", jres)):
        runner = pkg.ExperimentRunner(tmp_path / name)
        runner.run_grid("sweep", {"lr": [0.001, 0.01, 0.1]}, _experiment, seeds=(0, 1))
        lines = [json.loads(s) for s in (tmp_path / name / "runs.jsonl").read_text().splitlines()]
        for line in lines:
            line.pop("duration_s")
        reloaded = pkg.ExperimentRunner.load(tmp_path / name)
        analyzer = pkg.ResultsAnalyzer(reloaded.records)
        out[name] = (lines, analyzer.aggregate("auc"), analyzer.best("auc").params,
                     analyzer.seed_variance_report("auc"),
                     pkg.PublicationPreparer(analyzer).results_table(["auc"]))
    assert out["torch"] == out["jax"]
    assert sum(r["status"] == "failed" for r in out["torch"][0]) == 1
    path = tres.PublicationPreparer(tres.ResultsAnalyzer([])).export(tmp_path / "r.md", ["auc"])
    assert "torch" in path.read_text()


def test_region_summary_matches_jax(dgdm, feature_grads):
    _, _, jb, _, tb = dgdm
    sal = feature_grads["tsal"].node_saliency(tb, class_idx=0)[0]
    pos, mask = np.asarray(jb.pos)[0], np.asarray(jb.node_mask)[0]
    ref = jres.PathologyFeatureExtractor.summarize_regions(sal, pos, mask)
    assert tres.PathologyFeatureExtractor.summarize_regions(sal, pos, mask) == ref
    assert ref["num_nodes"] == 20
    empty = np.zeros(24, bool)
    assert tres.PathologyFeatureExtractor.summarize_regions(sal, pos, empty) == {"num_nodes": 0}


@pytest.mark.parametrize("language", ["en", "es"])
def test_report_matches_jax(language):
    prediction = {"predicted_class": 1, "confidence": 0.9,
                  "uncertainty": {"normalized_entropy": 0.5},
                  "biomarkers": [{"attention_score": 0.4, "position": [0.3, 0.7]}]}
    summary = {"num_nodes": 20, "salient_nodes": 2, "focality": 0.7,
               "salient_centroid": [0.25, 0.5]}
    names = ["benigno", "tumor"]
    ref = jres.ClinicalReportGenerator(names, language=language).generate(prediction, summary)
    out = tres.ClinicalReportGenerator(names, language=language).generate(prediction, summary)
    assert out == ref
    assert ("Predicción" if language == "es" else "Prediction") in out
    with pytest.raises(ValueError, match="unsupported language"):
        tres.ClinicalReportGenerator(language="xx")


def test_research_exports_match_jax_and_import_no_jax():
    assert tres.__all__ == jres.__all__
    import ast
    from pathlib import Path

    root = Path(tres.__file__).parent
    for path in list(root.glob("*.py")) + [root.parent / "utils" / "globalization.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "flax", "optax", "dgdm_histopath_tpu")
                           for n in names), path
