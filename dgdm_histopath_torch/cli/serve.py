"""``dgdm-serve`` on the port: the inference server over a model bundle
(counterpart of the JAX package's ``cli/serve.py``; the same flags, plus
``--device``), with optional dynamic request batching, and a clean stop on
SIGTERM or SIGINT (exit 0).

    python -m dgdm_histopath_torch.cli.serve --model out/final_model.npz \\
        --port 8080 --dynamic-batch 16 --warmup-nodes 1024

It serves on the card unless ``--device cpu`` is given; asking for the card
without one is an error. ``--port 0`` takes a free port (logged).
``--quant int8`` serves w8a8 int8 inference (``models/quantized.py``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..utils.device import resolve_device
from ..utils.logging import get_logger, setup_logging

logger = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgdm-serve")
    p.add_argument("--model", required=True, help="model bundle (.npz)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to serve (default: the card)")
    p.add_argument("--data-root", default=None,
                   help="enable graph_path loading confined to this dir")
    p.add_argument("--rate-limit", type=float, default=50.0,
                   help="requests/sec per client IP")
    p.add_argument("--dynamic-batch", type=int, default=0,
                   help="coalesce up to N concurrent /predict requests "
                        "into one device call (0 = serialize requests)")
    p.add_argument("--batch-wait-ms", type=float, default=5.0,
                   help="max queueing delay while a dynamic batch fills")
    p.add_argument("--batch-timeout-s", type=float, default=60.0,
                   help="per-request Future timeout inside the dynamic batcher")
    p.add_argument("--warmup-nodes", default=None,
                   help="comma-separated node-bucket sizes to warm at startup "
                        "(each power-of-two batch size runs once before "
                        "traffic), e.g. '1024,2048'")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="w8a8 int8 inference (int8 Dense layers)")
    p.add_argument("--feature-extractor", default="none",
                   help="patch featurizer for slide-path requests")
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
    from ..deployment import InferenceServer
    from ..evaluation import DGDMPredictor

    predictor = DGDMPredictor(model_path=args.model, device=device,
                              feature_extractor=args.feature_extractor, quant=args.quant)
    server = InferenceServer(predictor, port=args.port,
                             rate_limit_per_s=args.rate_limit,
                             data_root=args.data_root,
                             dynamic_batch=args.dynamic_batch,
                             batch_wait_ms=args.batch_wait_ms,
                             batch_timeout_s=args.batch_timeout_s)
    if args.warmup_nodes:
        for n in str(args.warmup_nodes).split(","):
            server.warmup(num_nodes=int(n))

    stopper = []

    def _term(signum, frame):
        # HTTPServer.shutdown() waits for the serve_forever loop: called from
        # a signal handler on the serving thread it deadlocks, so stop from a
        # helper thread and let serve_forever return
        logger.info("signal %d: draining and stopping server", signum)
        if not stopper:
            stopper.append(threading.Thread(target=server.stop, daemon=True))
            stopper[0].start()

    previous = {sig: signal.signal(sig, _term) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        server.start(background=False)  # returns after stop()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for t in stopper:
            t.join(timeout=30)
        predictor.close()
    logger.info("server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
