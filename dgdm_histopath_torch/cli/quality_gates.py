"""``dgdm-quality`` on the port: the quality-gate runner as a command
(counterpart of the JAX package's ``cli/quality_gates.py``; the same flags,
plus ``--device``).

    python -m dgdm_histopath_torch.cli.quality_gates --level production
    python -m dgdm_histopath_torch.cli.quality_gates --parallel 4 --cache-dir .gates

It prints a JSON summary (score, pass, each gate's status, cache hits) and
exits 0 when the level's rule holds, 1 when it does not. It runs on the
card unless ``--device cpu`` is given; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..utils.device import resolve_device
from ..utils.logging import get_logger, setup_logging

logger = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgdm-quality")
    p.add_argument("--level", choices=["greenfield", "development", "staging", "production"],
                   default="development", help="maturity level: which gates must pass")
    p.add_argument("--gates", type=str, default=None,
                   help="comma-separated subset of gate names")
    p.add_argument("--output", type=str, default=None, help="report json path")
    p.add_argument("--fail-fast", action="store_true")
    p.add_argument("--parallel", type=int, default=0, metavar="N",
                   help="run gates across N worker threads")
    p.add_argument("--cache-dir", type=str, default=None,
                   help="persistent result cache: an unchanged source tree serves the "
                        "gates that passed before")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the gates run (default: the card)")
    p.add_argument("--log-level", default="INFO")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(f"{exc} (--device cpu)")
    if args.parallel or args.cache_dir:
        from ..testing.scalable_gates import ScalableQualityGateRunner
        runner = ScalableQualityGateRunner(level=args.level, fail_fast=args.fail_fast,
                                           cache_dir=args.cache_dir,
                                           max_workers=args.parallel or 1, device=device)
    else:
        from ..testing.quality_gates import QualityGateRunner
        runner = QualityGateRunner(level=args.level, fail_fast=args.fail_fast, device=device)
    selected = args.gates.split(",") if args.gates else None
    report = runner.run(selected)
    summary = {"score": report["score"], "passed": report["passed"], "level": args.level,
               "gates": {g["name"]: g["status"] for g in report["gates"]}}
    for k in ("cache_hits", "parallel_speedup"):
        if report.get(k) is not None:
            summary[k] = report[k]
    print(json.dumps(summary, indent=2))
    if args.output:
        Path(args.output).write_text(json.dumps(report, indent=2))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
