"""Every function of the JAX package's ``evaluation/metrics.py`` against the
port's, on seeded inputs. Both are numpy on the host with the same
arithmetic and the same ``RandomState`` draws, so every result must be equal
to the bit (NaN equal to NaN), bootstrap intervals included."""

import numpy as np
import pytest

from conftest import make_synthetic_graph
from dgdm_histopath_torch.evaluation import metrics as tm
from dgdm_histopath_tpu.evaluation import metrics as jm
from test_torch_training import to_torch_graph

SEEDS = [0, 1, 7]


def _inputs(seed, n=48, classes=4):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 2, n)
    scores = np.round(rs.rand(n), 2)             # rounded: ties in the ranks
    logits = rs.randn(n, classes)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    multi = rs.randint(0, classes, n)
    return rs, labels, scores, probs, multi


def _same(a, b):
    np.testing.assert_equal(a, b)
    assert type(a) is type(b)


@pytest.mark.parametrize("seed", SEEDS)
def test_roc_and_pr_auc(seed):
    _, labels, scores, _, _ = _inputs(seed)
    _same(tm._roc_auc(labels, scores), jm._roc_auc(labels, scores))
    _same(tm._pr_auc(labels, scores), jm._pr_auc(labels, scores))
    _same(tm._roc_auc(np.ones(5, int), scores[:5]), jm._roc_auc(np.ones(5, int), scores[:5]))


@pytest.mark.parametrize("seed", SEEDS)
def test_classification_metrics_binary_and_multiclass(seed):
    _, labels, scores, probs, multi = _inputs(seed)
    _same(tm.compute_classification_metrics(labels, scores),
          jm.compute_classification_metrics(labels, scores))
    _same(tm.compute_classification_metrics(multi, probs),
          jm.compute_classification_metrics(multi, probs))
    _same(tm.macro_ovr_auc(multi, probs), jm.macro_ovr_auc(multi, probs))
    _same(tm.macro_ovr_auc(multi, probs, metric=tm._pr_auc),
          jm.macro_ovr_auc(multi, probs, metric=jm._pr_auc))


@pytest.mark.parametrize("seed", SEEDS)
def test_kappa_and_expected_grade(seed):
    rs, _, _, probs, multi = _inputs(seed)
    preds = np.clip(multi + rs.randint(-1, 2, len(multi)), 0, 3)
    _same(tm.quadratic_weighted_kappa(multi, preds), jm.quadratic_weighted_kappa(multi, preds))
    _same(tm.quadratic_weighted_kappa(multi, preds, n_classes=6),
          jm.quadratic_weighted_kappa(multi, preds, n_classes=6))
    _same(tm.quadratic_weighted_kappa(multi[:0], preds[:0]),
          jm.quadratic_weighted_kappa(multi[:0], preds[:0]))
    _same(tm.expected_grade_decode(probs), jm.expected_grade_decode(probs))


@pytest.mark.parametrize("seed", SEEDS)
def test_regression_and_survival(seed):
    rs = np.random.RandomState(seed)
    t = rs.randn(40)
    t[3] = 0.0                                   # a zero target leaves MAPE
    p = t + 0.3 * rs.randn(40)
    _same(tm.compute_regression_metrics(t, p), jm.compute_regression_metrics(t, p))
    times = rs.randint(1, 20, 40).astype(float)
    risks = np.round(rs.randn(40), 1)
    events = rs.rand(40) < 0.6
    _same(tm.concordance_index(times, risks, events), jm.concordance_index(times, risks, events))


@pytest.mark.parametrize("seed", SEEDS)
def test_segmentation_and_clinical(seed):
    rs = np.random.RandomState(seed)
    a, b = rs.rand(32, 32) < 0.4, rs.rand(32, 32) < 0.5
    _same(tm.dice_score(a, b), jm.dice_score(a, b))
    _same(tm.iou_score(a, b), jm.iou_score(a, b))
    _same(tm.compute_segmentation_metrics(a, b), jm.compute_segmentation_metrics(a, b))
    y, p = rs.rand(60) < 0.3, rs.rand(60) < 0.4
    _same(tm.compute_clinical_metrics(y, p), jm.compute_clinical_metrics(y, p))
    _same(tm.compute_clinical_metrics(y & False, p & False),
          jm.compute_clinical_metrics(y & False, p & False))


@pytest.mark.parametrize("seed", SEEDS)
def test_graph_statistics_of_a_padded_graph(seed):
    g = make_synthetic_graph(n_nodes=64, n_real=40 + seed, feat_dim=8, seed=seed)
    _same(tm.compute_graph_statistics(to_torch_graph(g)), jm.compute_graph_statistics(g))


@pytest.mark.parametrize("seed", SEEDS)
def test_bootstrap_ci(seed):
    _, labels, scores, probs, multi = _inputs(seed)
    kw = dict(n_bootstrap=200, seed=seed)
    _same(tm.bootstrap_ci(tm._roc_auc, labels, scores, **kw),
          jm.bootstrap_ci(jm._roc_auc, labels, scores, **kw))
    _same(tm.bootstrap_ci(tm.macro_ovr_auc, multi, probs, alpha=0.1, **kw),
          jm.bootstrap_ci(jm.macro_ovr_auc, multi, probs, alpha=0.1, **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_paired_bootstrap_delta(seed):
    rs, labels, scores, _, _ = _inputs(seed)
    other = np.clip(scores + 0.2 * rs.randn(len(scores)), 0, 1)
    kw = dict(n_bootstrap=200, seed=seed)
    _same(tm.paired_bootstrap_delta(tm._roc_auc, labels, scores, other, **kw),
          jm.paired_bootstrap_delta(jm._roc_auc, labels, scores, other, **kw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("resample_seeds", [True, False])
def test_pooled_paired_bootstrap_delta(seed, resample_seeds):
    rs, labels, scores, _, _ = _inputs(seed)
    a = [np.clip(scores + 0.1 * rs.randn(len(scores)), 0, 1) for _ in range(3)]
    b = [np.clip(scores + 0.2 * rs.randn(len(scores)), 0, 1) for _ in range(3)]
    b[1] = np.full(len(scores), np.nan)          # a seed with a non-finite delta
    kw = dict(n_bootstrap=100, seed=seed, resample_seeds=resample_seeds)
    _same(tm.pooled_paired_bootstrap_delta(tm._roc_auc, labels, a, b, **kw),
          jm.pooled_paired_bootstrap_delta(jm._roc_auc, labels, a, b, **kw))
    with pytest.raises(ValueError, match="replicate counts"):
        tm.pooled_paired_bootstrap_delta(tm._roc_auc, labels, a, b[:2])


def test_every_jax_metric_has_a_port_counterpart():
    public = {n for n in dir(jm) if callable(getattr(jm, n)) and not n.startswith("__")
              and getattr(getattr(jm, n), "__module__", None) == jm.__name__}
    assert public <= set(dir(tm)), public - set(dir(tm))
