"""Evaluation metrics on the host (numpy). Only what the trainer's validation
needs is here; the rest of the JAX package's ``evaluation/metrics.py`` waits
for the evaluation slice."""

from __future__ import annotations

import numpy as np


def concordance_index(times: np.ndarray, risks: np.ndarray, events: np.ndarray) -> float:
    """Harrell's C-index over the comparable-pair matrix: pair (i, j) is
    comparable when t_i < t_j and i had the event; ties in risk count half.
    NaN when no pair is comparable."""
    t = np.asarray(times, np.float64)
    r = np.asarray(risks, np.float64)
    e = np.asarray(events).astype(bool)
    comparable = (t[:, None] < t[None, :]) & e[:, None]
    n_comp = comparable.sum()
    if n_comp == 0:
        return float("nan")
    higher = r[:, None] > r[None, :]
    tied = r[:, None] == r[None, :]
    concordant = (comparable & higher).sum() + 0.5 * (comparable & tied).sum()
    return float(concordant / n_comp)
