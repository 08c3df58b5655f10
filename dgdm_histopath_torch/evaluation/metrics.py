"""Evaluation metrics: classification, regression, survival, segmentation,
graph statistics, clinical rates and bootstrap confidence intervals
(counterpart of the JAX package's ``evaluation/metrics.py``).

They run on the host in numpy, in both packages, with the same arithmetic and
the same ``np.random.RandomState(seed)`` draws, so every result (the
bootstrap intervals included) equals the JAX package's to the bit.
``compute_graph_statistics`` takes the port's ``PaddedGraph`` (tensors on any
device).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def _roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic (ties handled by midranks)."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]))
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # midranks for ties
    allscores = np.concatenate([pos, neg])
    sorted_scores = allscores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            mid = (i + j + 2) / 2.0
            ranks[order[i:j + 1]] = mid
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2.0) / (len(pos) * len(neg)))


def _pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision (area under PR curve, step interpolation)."""
    order = np.argsort(-scores, kind="stable")
    l_sorted = labels[order]
    tp = np.cumsum(l_sorted)
    precision = tp / np.arange(1, len(l_sorted) + 1)
    n_pos = l_sorted.sum()
    if n_pos == 0:
        return float("nan")
    return float((precision * l_sorted).sum() / n_pos)


def compute_classification_metrics(
    labels: np.ndarray,
    probabilities: np.ndarray,
    threshold: float = 0.5,
) -> Dict[str, float]:
    """accuracy / precision / recall / F1 (macro) / ROC-AUC / PR-AUC /
    confusion matrix."""
    labels = np.asarray(labels).astype(int)
    probs = np.asarray(probabilities, np.float64)
    if probs.ndim == 1:
        probs = np.stack([1 - probs, probs], axis=1)
    n_classes = probs.shape[1]
    preds = probs.argmax(axis=1)

    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(labels, preds):
        cm[t, p] += 1
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    f1 = np.where(precision + recall > 0,
                  2 * precision * recall / np.maximum(precision + recall, 1e-12), 0.0)

    out: Dict[str, float] = {
        "accuracy": float((preds == labels).mean()) if len(labels) else float("nan"),
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1": float(f1.mean()),
        "confusion_matrix": cm.tolist(),
    }
    if n_classes == 2:
        out["auc"] = _roc_auc(labels, probs[:, 1])
        out["pr_auc"] = _pr_auc(labels, probs[:, 1])
    else:
        # one-vs-rest macro AUC
        out["auc"] = macro_ovr_auc(labels, probs)
        out["pr_auc"] = macro_ovr_auc(labels, probs, metric=_pr_auc)
    return out


def macro_ovr_auc(labels: np.ndarray, probs: np.ndarray,
                  metric=None) -> float:
    """One-vs-rest macro AUC over a ``[N, C]`` probability matrix.
    Degenerate classes (absent from ``labels``) are skipped; NaN when none
    remain. Usable directly as the ``metric_fn`` of the bootstrap helpers
    (they resample rows of both ``labels`` and ``probs``)."""
    metric = metric or _roc_auc
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    vals = []
    for c in range(probs.shape[-1]):
        binary = (labels == c).astype(int)
        if binary.sum() in (0, len(binary)):
            continue
        vals.append(metric(binary, probs[:, c]))
    return float(np.mean(vals)) if vals else float("nan")


def quadratic_weighted_kappa(labels: np.ndarray, preds: np.ndarray,
                             n_classes: int = None) -> float:
    """Cohen's kappa with quadratic weights — the standard ordinal-grading
    agreement metric (PANDA ISUP grading).

    ``kappa = 1 - Σ W·O / Σ W·E`` with ``W[i,j] = (i-j)² / (n-1)²``,
    observed matrix O and outer-product expected matrix E.
    """
    labels = np.asarray(labels).astype(int)
    preds = np.asarray(preds).astype(int)
    if n_classes is None:
        n_classes = int(max(labels.max(), preds.max())) + 1 if len(labels) else 2
    if n_classes < 2 or len(labels) == 0:
        return float("nan")
    obs = np.zeros((n_classes, n_classes), np.float64)
    for t, p in zip(labels, preds):
        obs[t, p] += 1.0
    hist_t = obs.sum(axis=1)
    hist_p = obs.sum(axis=0)
    expected = np.outer(hist_t, hist_p) / max(len(labels), 1)
    ii, jj = np.meshgrid(np.arange(n_classes), np.arange(n_classes),
                         indexing="ij")
    w = (ii - jj) ** 2 / float((n_classes - 1) ** 2)
    denom = float((w * expected).sum())
    if denom == 0.0:
        return float("nan")
    return float(1.0 - (w * obs).sum() / denom)


def expected_grade_decode(probabilities: np.ndarray) -> np.ndarray:
    """Ordinal decode: round the probability-weighted expected grade —
    the standard PANDA decode (penalizes far misses less than argmax
    under quadratic-weighted kappa)."""
    probs = np.asarray(probabilities, np.float64)
    grades = np.arange(probs.shape[-1], dtype=np.float64)
    exp = (probs * grades).sum(axis=-1)
    return np.clip(np.rint(exp), 0, probs.shape[-1] - 1).astype(int)


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------

def compute_regression_metrics(targets: np.ndarray, predictions: np.ndarray
                               ) -> Dict[str, float]:
    """mse / rmse / mae / r2 / mape."""
    t = np.asarray(targets, np.float64).ravel()
    p = np.asarray(predictions, np.float64).ravel()
    err = p - t
    mse = float(np.mean(err ** 2))
    ss_res = float(np.sum(err ** 2))
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    nonzero = np.abs(t) > 1e-12
    mape = float(np.mean(np.abs(err[nonzero] / t[nonzero])) * 100) if nonzero.any() else float("nan")
    return {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": float(np.mean(np.abs(err))),
        "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan"),
        "mape": mape,
    }


# ---------------------------------------------------------------------------
# survival
# ---------------------------------------------------------------------------

def concordance_index(times: np.ndarray, risks: np.ndarray,
                      events: np.ndarray) -> float:
    """Harrell's C-index over the comparable-pair matrix: pair (i, j) is
    comparable when t_i < t_j and i had the event; ties in risk count half.
    NaN when no pair is comparable."""
    t = np.asarray(times, np.float64)
    r = np.asarray(risks, np.float64)
    e = np.asarray(events).astype(bool)
    # pair (i, j) comparable if t_i < t_j and event_i
    comparable = (t[:, None] < t[None, :]) & e[:, None]
    n_comp = comparable.sum()
    if n_comp == 0:
        return float("nan")
    higher = r[:, None] > r[None, :]
    tied = r[:, None] == r[None, :]
    concordant = (comparable & higher).sum() + 0.5 * (comparable & tied).sum()
    return float(concordant / n_comp)


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def dice_score(pred_mask: np.ndarray, true_mask: np.ndarray,
               smooth: float = 1e-6) -> float:
    p = np.asarray(pred_mask).astype(bool)
    t = np.asarray(true_mask).astype(bool)
    inter = (p & t).sum()
    return float((2.0 * inter + smooth) / (p.sum() + t.sum() + smooth))


def iou_score(pred_mask: np.ndarray, true_mask: np.ndarray,
              smooth: float = 1e-6) -> float:
    p = np.asarray(pred_mask).astype(bool)
    t = np.asarray(true_mask).astype(bool)
    inter = (p & t).sum()
    union = (p | t).sum()
    return float((inter + smooth) / (union + smooth))


def compute_segmentation_metrics(pred_mask: np.ndarray, true_mask: np.ndarray
                                 ) -> Dict[str, float]:
    return {"dice": dice_score(pred_mask, true_mask),
            "iou": iou_score(pred_mask, true_mask)}


# ---------------------------------------------------------------------------
# graph statistics
# ---------------------------------------------------------------------------

def compute_graph_statistics(graph) -> Dict[str, float]:
    """Node/edge counts and degree stats of a PaddedGraph."""
    mask = graph.node_mask.cpu().numpy()
    em = graph.nbr_mask.cpu().numpy() & mask[..., None]
    deg = em.sum(axis=-1)[mask]
    return {
        "num_nodes": int(mask.sum()),
        "num_edges": int(em.sum()),
        "mean_degree": float(deg.mean()) if len(deg) else 0.0,
        "max_degree": int(deg.max()) if len(deg) else 0,
        "density": float(em.sum() / max(mask.sum() ** 2 - mask.sum(), 1)),
    }


# ---------------------------------------------------------------------------
# clinical
# ---------------------------------------------------------------------------

def compute_clinical_metrics(labels: np.ndarray, predictions: np.ndarray
                             ) -> Dict[str, float]:
    """sensitivity / specificity / ppv / npv on binary labels."""
    y = np.asarray(labels).astype(bool)
    p = np.asarray(predictions).astype(bool)
    tp = float((y & p).sum())
    tn = float((~y & ~p).sum())
    fp = float((~y & p).sum())
    fn = float((y & ~p).sum())
    safe = lambda a, b: a / b if b > 0 else float("nan")
    return {
        "sensitivity": safe(tp, tp + fn),
        "specificity": safe(tn, tn + fp),
        "ppv": safe(tp, tp + fp),
        "npv": safe(tn, tn + fn),
        "prevalence": safe(tp + fn, tp + tn + fp + fn),
    }


# ---------------------------------------------------------------------------
# bootstrap confidence intervals
# ---------------------------------------------------------------------------

def bootstrap_ci(
    metric_fn,
    labels: np.ndarray,
    scores: np.ndarray,
    n_bootstrap: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Dict[str, float]:
    """Percentile bootstrap CI for any (labels, scores) -> float metric."""
    rs = np.random.RandomState(seed)
    n = len(labels)
    point = metric_fn(labels, scores)
    stats = []
    for _ in range(n_bootstrap):
        idx = rs.randint(0, n, n)
        v = metric_fn(labels[idx], scores[idx])
        if np.isfinite(v):
            stats.append(v)
    if not stats:
        return {"value": point, "lower": float("nan"), "upper": float("nan")}
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {"value": float(point), "lower": float(lo), "upper": float(hi),
            "n_bootstrap": len(stats)}


def paired_bootstrap_delta(
    metric_fn,
    labels: np.ndarray,
    scores_a: np.ndarray,
    scores_b: np.ndarray,
    n_bootstrap: int = 2000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Dict[str, float]:
    """Paired percentile-bootstrap CI for ``metric(b) - metric(a)`` on the
    SAME test set: each resample draws one index set and evaluates both
    score vectors on it, so between-slide variance cancels and the CI
    reflects only the systems' disagreement. This is the right test for
    accuracy A/Bs (dense vs windowed/int8/MoE, pretrain vs scratch) —
    two independent CIs overlapping says much less than the paired delta.
    """
    labels = np.asarray(labels)
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    rs = np.random.RandomState(seed)
    n = len(labels)
    point = metric_fn(labels, scores_b) - metric_fn(labels, scores_a)
    deltas = []
    for _ in range(n_bootstrap):
        idx = rs.randint(0, n, n)
        va = metric_fn(labels[idx], scores_a[idx])
        vb = metric_fn(labels[idx], scores_b[idx])
        if np.isfinite(va) and np.isfinite(vb):
            deltas.append(vb - va)
    if not deltas:
        return {"delta": float(point), "lower": float("nan"),
                "upper": float("nan")}
    lo, hi = np.percentile(deltas, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {"delta": float(point), "lower": float(lo), "upper": float(hi),
            "n_bootstrap": len(deltas)}


def pooled_paired_bootstrap_delta(
    metric_fn,
    labels: np.ndarray,
    scores_a_by_seed,
    scores_b_by_seed,
    n_bootstrap: int = 2000,
    alpha: float = 0.05,
    seed: int = 0,
    resample_seeds: bool = True,
) -> Dict[str, float]:
    """Multi-seed pooling of :func:`paired_bootstrap_delta`: the statistic
    is the MEAN over training-seed replicates of ``metric(b_s) - metric(a_s)``
    on one shared slide resample per bootstrap draw. Replicates share the
    test set (only training init/shuffling/splits vary), so the same index
    set is applied to every replicate of both arms — slide-sampling variance
    cancels within each pair, and averaging across seeds shrinks the
    training-noise component a single-seed delta cannot distinguish from the
    systematic effect. Use when one seed's paired CI straddles zero but the
    effect replicates in sign (e.g. the pretrain-vs-scratch uplift on the
    calibrated hard gate).

    ``resample_seeds=True`` (default) makes this a TWO-LEVEL (cluster)
    bootstrap: each draw resamples the seed replicates WITH replacement in
    addition to the slides, so between-seed variance — the dominant error
    term when per-seed deltas swing (e.g. +0.17 / −0.20 across two training
    seeds) — widens the interval instead of silently vanishing. With
    ``False`` the seed set is treated as fixed and the CI reflects only
    slide-sampling noise around the observed seed mean (it UNDERSTATES
    uncertainty whenever seeds disagree). With a single replicate the two modes coincide and both reduce bit-exactly to
    :func:`paired_bootstrap_delta`.

    Seeds whose full-set delta is non-finite (degenerate resample, NaN
    scores) are dropped from BOTH the point estimate and the bootstrap, and
    counted in ``n_seeds_dropped``.

    ``scores_a_by_seed`` / ``scores_b_by_seed``: sequences of per-seed score
    vectors, index-aligned (seed k of ``a`` trained with the same seed as
    seed k of ``b``); both must have the same number of replicates.
    """
    labels = np.asarray(labels)
    sa = [np.asarray(s) for s in scores_a_by_seed]
    sb = [np.asarray(s) for s in scores_b_by_seed]
    if len(sa) != len(sb) or not sa:
        raise ValueError(
            f"need equal, non-zero replicate counts (got {len(sa)} vs {len(sb)})")
    per_seed_all = [float(metric_fn(labels, b) - metric_fn(labels, a))
                    for a, b in zip(sa, sb)]
    keep = [i for i, d in enumerate(per_seed_all) if np.isfinite(d)]
    dropped = len(sa) - len(keep)
    sa, sb = [sa[i] for i in keep], [sb[i] for i in keep]
    per_seed = [per_seed_all[i] for i in keep]
    if not per_seed:
        return {"delta": float("nan"), "lower": float("nan"),
                "upper": float("nan"), "per_seed": [], "n_seeds": 0,
                "n_seeds_dropped": dropped,
                "resample_seeds": bool(resample_seeds)}
    rs = np.random.RandomState(seed)
    n = len(labels)
    k = len(sa)
    point = float(np.mean(per_seed))
    deltas = []
    for _ in range(n_bootstrap):
        idx = rs.randint(0, n, n)
        # cluster level: resample which seed replicates enter this draw
        # (k == 1 is a no-op, preserving paired_bootstrap_delta equivalence
        # draw-for-draw)
        sidx = (rs.randint(0, k, k) if resample_seeds and k > 1
                else range(k))
        vals = []
        for s in sidx:
            va = metric_fn(labels[idx], sa[s][idx])
            vb = metric_fn(labels[idx], sb[s][idx])
            if np.isfinite(va) and np.isfinite(vb):
                vals.append(vb - va)
        if vals:
            deltas.append(float(np.mean(vals)))
    if not deltas:
        return {"delta": point, "lower": float("nan"), "upper": float("nan"),
                "per_seed": per_seed, "n_seeds": k,
                "n_seeds_dropped": dropped,
                "resample_seeds": bool(resample_seeds)}
    lo, hi = np.percentile(deltas, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {"delta": point, "lower": float(lo), "upper": float(hi),
            "per_seed": per_seed, "n_seeds": k, "n_seeds_dropped": dropped,
            "n_bootstrap": len(deltas),
            "resample_seeds": bool(resample_seeds)}
