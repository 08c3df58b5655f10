"""Hold one run of the calibrated hard gate against another, train seed by
train seed: the port's arms against the JAX package's, or a rerun against
the committed arms.

Both ``--ref`` and ``--run`` are ``--out`` folders of ``eval_camelyon16
--hard --ab-pretrain`` (either package's) over the same data seed, so their
arms share the test slides. For every train seed that both hold a dense and
a scratch arm of, it reads the dense AUC, the scratch AUC and the pretrain
uplift (dense minus scratch) of each run, and reports

- each run's means, the two-level 95% CI of its mean dense AUC
  (:func:`pooled_auc_ci`) and of its uplift (``pooled_paired_bootstrap_delta``
  with the seeds resampled, as ``aggregate_hard_seeds`` pools it);
- the per-seed differences (run minus ref) of the three, each with a
  percentile-bootstrap 95% CI of their mean over the seeds (the seeds
  resampled);
- ``fault``: true where one of those three CIs excludes zero.

    python -m dgdm_histopath_torch.scripts.compare_gate_runs --ref JAX_OUT \\
        --run PORT_OUT --cpu > compare.json

The arithmetic is on the host in f64; like every entry point of the port it
asks for the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..evaluation.metrics import _roc_auc, pooled_paired_bootstrap_delta
from . import resolve
from .aggregate_hard_seeds import load_arms

ARMS = ("dense", "scratch")


def pooled_auc_ci(labels, probs_by_seed, n_bootstrap: int = 2000, seed: int = 0) -> list:
    """Two-level percentile-bootstrap 95% CI of the mean AUC over seeds: each
    draw resamples the seeds and, shared by them, the test slides."""
    rs = np.random.RandomState(seed)
    n, k = len(labels), len(probs_by_seed)
    vals = []
    for _ in range(n_bootstrap):
        seeds, idx = rs.randint(0, k, k), rs.randint(0, n, n)
        v = float(np.mean([_roc_auc(labels[idx], probs_by_seed[s][idx]) for s in seeds]))
        if math.isfinite(v):
            vals.append(v)
    return [float(x) for x in np.percentile(vals, [2.5, 97.5])]


def mean_ci(values: Sequence[float], n_bootstrap: int = 2000, seed: int = 0) -> list:
    """Percentile-bootstrap 95% CI of the mean of ``values`` (resampled with
    replacement)."""
    v = np.asarray(values, np.float64)
    rs = np.random.RandomState(seed)
    means = v[rs.randint(0, len(v), (n_bootstrap, len(v)))].mean(axis=1)
    return [float(x) for x in np.percentile(means, [2.5, 97.5])]


def _side(arms: Dict, labels: np.ndarray, seeds: Sequence[int], n_bootstrap: int) -> Dict:
    probs = {tag: [arms[tag][s]["probs"] for s in seeds] for tag in ARMS}
    aucs = {tag: [float(_roc_auc(labels, p)) for p in probs[tag]] for tag in ARMS}
    uplift = [d - s for d, s in zip(aucs["dense"], aucs["scratch"])]
    pooled = pooled_paired_bootstrap_delta(_roc_auc, labels, probs["scratch"], probs["dense"],
                                           n_bootstrap=n_bootstrap, resample_seeds=True)
    return {"dense_auc_by_seed": aucs["dense"], "scratch_auc_by_seed": aucs["scratch"],
            "uplift_by_seed": uplift,
            "dense_auc_mean": float(np.mean(aucs["dense"])),
            "scratch_auc_mean": float(np.mean(aucs["scratch"])),
            "uplift_mean": float(np.mean(uplift)),
            "dense_auc_ci95_two_level": pooled_auc_ci(labels, probs["dense"], n_bootstrap),
            "uplift_ci95_two_level": [float(pooled["lower"]), float(pooled["upper"])]}


def compare(ref_dir: Path, run_dir: Path, seeds: Optional[Sequence[int]] = None,
            n_bootstrap: int = 2000) -> Dict:
    """The comparison of ``run_dir``'s arms with ``ref_dir``'s (see the
    module docstring)."""
    ref_arms, ref_labels = load_arms(Path(ref_dir))
    run_arms, run_labels = load_arms(Path(run_dir))
    if ref_labels is None or run_labels is None:
        raise SystemExit(f"no variant_*.npz under {ref_dir if ref_labels is None else run_dir}")
    if not np.array_equal(ref_labels, run_labels):
        raise SystemExit("the two runs' test labels differ: they are not on one test set")
    held = [set(arms.get(tag, {})) for arms in (ref_arms, run_arms) for tag in ARMS]
    common = sorted(set.intersection(*held))
    seeds = common if seeds is None else list(seeds)
    missing = sorted(set(seeds) - set(common))
    if missing or len(seeds) < 2:
        raise SystemExit(f"dense and scratch arms of both runs are needed for two seeds or "
                         f"more; missing train seeds {missing} (both hold {common})")
    ref = _side(ref_arms, ref_labels, seeds, n_bootstrap)
    run = _side(run_arms, run_labels, seeds, n_bootstrap)
    diffs = {}
    for key in ("dense_auc", "scratch_auc", "uplift"):
        d = [a - b for a, b in zip(run[f"{key}_by_seed"], ref[f"{key}_by_seed"])]
        ci = mean_ci(d, n_bootstrap)
        diffs[key] = {"by_seed": d, "mean": float(np.mean(d)), "ci95": ci,
                      "ci_excludes_zero": bool(ci[0] > 0 or ci[1] < 0)}
    return {"ref": str(ref_dir), "run": str(run_dir), "train_seeds": seeds,
            "n_test": int(len(ref_labels)), "ref_arms": ref, "run_arms": run,
            "differences": diffs,
            "fault": any(d["ci_excludes_zero"] for d in diffs.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="compare_gate_runs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--ref", type=Path, required=True, help="the reference run's --out")
    ap.add_argument("--run", type=Path, required=True, help="the run held to it")
    ap.add_argument("--cpu", action="store_true", help="run where there is no card")
    args = ap.parse_args(argv)
    resolve(ap, args.cpu)
    report = compare(args.ref, args.run)
    print(json.dumps(report, indent=2))
    return report
