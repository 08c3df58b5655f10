"""Pool the calibrated hard-gate A/B arms across training seeds
(counterpart of the repository's ``scripts/aggregate_hard_seeds.py``; it
reads either package's arms).

``eval_camelyon16 --hard`` keeps every finished arm as
``variant_{tag}_s{data_seed}[t{train_seed}].npz`` (test probabilities,
labels, metrics). Replicating the arms with ``--train-seed K`` varies only
the training procedure (split, shuffle, init) while the data, and so the
test set, stays pinned to ``--seed``: the replicates are index-aligned and
pool with ``evaluation.metrics.pooled_paired_bootstrap_delta`` (the mean
over seeds of the paired delta, one shared slide resample per draw; the
headline CI resamples the seeds too).

    python -m dgdm_histopath_torch.scripts.aggregate_hard_seeds \
        [--dir docs/results/c16_hard] [--report report_pooled.json] [--cpu]

Writes ``{dir}/{report}`` and prints it. The pooling is host arithmetic in
f64 (the JAX script's numbers to the last bit); like every entry point of
the port it asks for the card unless ``--cpu`` is given, and without one it
stops with a usage error before it reads an arm.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np

from ..evaluation.metrics import _roc_auc, macro_ovr_auc, pooled_paired_bootstrap_delta
from . import resolve

_VAR_RE = re.compile(r"variant_(?P<tag>.+)_s(?P<seed>\d+)(?:t(?P<tseed>\d+))?\.npz$")

# (report key, arm A, arm B): delta = AUC(B) - AUC(A); pretrain uplift is
# dense-over-scratch, the perf/memory levers are lever-over-dense.
# window32 keeps the legacy promoted-config key; any other window{W} or
# moe{E} arm found on disk gets a {tag}_auc_delta_vs_dense entry (see
# discover_comparisons).
_COMPARISONS = [
    ("pretrain_auc_uplift", "scratch", "dense"),
    ("window_auc_delta_vs_dense", "dense", "window32"),
]


def discover_comparisons(arms):
    """Extend _COMPARISONS with every window{W}/moe{E} arm present."""
    comps = list(_COMPARISONS)
    covered = {b for _, _, b in comps}
    for tag in sorted(arms):
        if tag in covered or tag in ("dense", "scratch"):
            continue
        if re.fullmatch(r"(window|moe)\d+", tag):
            comps.append((f"{tag}_auc_delta_vs_dense", "dense", tag))
    return comps


def load_arms(out_dir: Path):
    """-> {tag: {train_seed: npz-dict}}, shared labels array."""
    arms: dict = {}
    labels = None
    for p in sorted(out_dir.glob("variant_*.npz")):
        m = _VAR_RE.match(p.name)
        if not m:
            continue
        tag = m.group("tag")
        tseed = int(m.group("tseed") or m.group("seed"))
        with np.load(p, allow_pickle=True) as z:
            rec = {"probs": np.asarray(z["probs"], dtype=np.float64),
                   "labels": np.asarray(z["labels"])}
            if "probs_int8" in z.files:
                rec["probs_int8"] = np.asarray(z["probs_int8"], dtype=np.float64)
        if labels is None:
            labels = rec["labels"]
        elif not np.array_equal(labels, rec["labels"]):
            raise SystemExit(
                f"{p.name}: test labels differ from earlier arms — the "
                "replicates are not on the same test set (data --seed must "
                "stay fixed; only --train-seed may vary)")
        arms.setdefault(tag, {})[tseed] = rec
    return arms, labels


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aggregate_hard_seeds",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--dir", type=Path, default=Path("docs/results/c16_hard"))
    ap.add_argument("--report", default="report_pooled.json")
    ap.add_argument("--n-bootstrap", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true", help="run where there is no card")
    args = ap.parse_args(argv)
    resolve(ap, args.cpu)

    arms, labels = load_arms(args.dir)
    if labels is None:
        raise SystemExit(f"no variant_*.npz found under {args.dir}")

    # binary arms store 1-d tumor-probability vectors; multi-class arms
    # (eval_tcga --hard) store [N, C] matrices and pool with macro OVR AUC
    multiclass = any(r["probs"].ndim == 2
                     for by_seed in arms.values() for r in by_seed.values())
    _metric = macro_ovr_auc if multiclass else _roc_auc

    report = {"dataset": ("multiclass-hard" if multiclass
                          else "camelyon16-synthetic-hard"),
              "auc_metric": "macro_ovr" if multiclass else "binary",
              "n_test": len(labels), "arms": {}}
    for tag, by_seed in sorted(arms.items()):
        seeds = sorted(by_seed)
        aucs = {s: float(_metric(labels, by_seed[s]["probs"])) for s in seeds}
        report["arms"][tag] = {
            "train_seeds": seeds,
            "auc_by_seed": {str(s): round(a, 4) for s, a in aucs.items()},
            "auc_mean": round(float(np.mean(list(aucs.values()))), 4),
        }

    def pooled_entry(probs_a, probs_b, common):
        """Headline CI is the TWO-LEVEL bootstrap (slides AND seeds
        resampled — between-seed variance, the dominant error term on this
        gate, enters the interval); ``ci95_fixed_seeds`` records the
        slides-only CI around the observed seed mean for comparison."""
        d = pooled_paired_bootstrap_delta(
            _metric, labels, probs_a, probs_b,
            n_bootstrap=args.n_bootstrap, resample_seeds=True)
        d_fixed = pooled_paired_bootstrap_delta(
            _metric, labels, probs_a, probs_b,
            n_bootstrap=args.n_bootstrap, resample_seeds=False)
        entry = {
            "delta": round(d["delta"], 4),
            "ci95": [round(d["lower"], 4), round(d["upper"], 4)],
            "ci95_fixed_seeds": [round(d_fixed["lower"], 4),
                                 round(d_fixed["upper"], 4)],
            "per_seed": [round(v, 4) for v in d["per_seed"]],
            "seed_std": round(float(np.std(d["per_seed"], ddof=1)), 4)
                        if len(d["per_seed"]) > 1 else None,
            "train_seeds": common,
            "ci_excludes_zero": bool(d["lower"] > 0 or d["upper"] < 0),
        }
        if d.get("n_seeds_dropped"):
            entry["n_seeds_dropped"] = d["n_seeds_dropped"]
        return entry

    for key, a_tag, b_tag in discover_comparisons(arms):
        a, b = arms.get(a_tag), arms.get(b_tag)
        if not a or not b:
            continue
        common = sorted(set(a) & set(b))
        if not common:
            continue
        report[key] = pooled_entry([a[s]["probs"] for s in common],
                                   [b[s]["probs"] for s in common], common)

    # propagate the window-binding diagnostic from the per-seed reports so
    # the pooled artifact is self-describing: a non-binding window arm's
    # delta is training noise, not windowed-semantics evidence (round-5
    # finding — the bucket-256 gate's ~29-real-node graphs never bind
    # windows >= 16)
    for rp in sorted(args.dir.glob("report_*.json")):
        if rp.name == args.report:
            continue
        try:
            seed_report = json.loads(rp.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if "window_binding" in seed_report:
            report["window_binding"] = seed_report["window_binding"]
            if "real_nodes" in seed_report:
                report["real_nodes"] = seed_report["real_nodes"]
            break

    dense = arms.get("dense", {})
    int8_seeds = sorted(s for s, r in dense.items() if "probs_int8" in r)
    if int8_seeds:
        report["int8_auc_delta"] = pooled_entry(
            [dense[s]["probs"] for s in int8_seeds],
            [dense[s]["probs_int8"] for s in int8_seeds], int8_seeds)

    out = args.dir / args.report
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    print(f"[aggregate_hard_seeds] report -> {out}")
    return report


if __name__ == "__main__":
    main()
