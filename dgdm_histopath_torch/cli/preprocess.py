"""``dgdm-preprocess`` on the port: offline slide preprocessing
(counterpart of the JAX package's ``cli/preprocess.py``; the same
subcommands, flags and outputs, plus ``--device``).

    python -m dgdm_histopath_torch.cli.preprocess process-slides \\
        --input-dir slides/ --output-dir h5/
    python -m dgdm_histopath_torch.cli.preprocess build-graphs \\
        --input-dir h5/ --output-dir graphs/ [--model-config model.yaml]
    python -m dgdm_histopath_torch.cli.preprocess validate-preprocessing --dir graphs/

``process-slides`` writes one ``<stem>.h5`` slide-data file a slide
(``SlideProcessor.save_slide_data``; a thread pool, existing outputs kept);
``build-graphs`` one ``<stem>_graph.npz`` a slide-data file; and
``validate-preprocessing`` prints a JSON count of the readable and the
broken files. Each exits 1 when any file fails or none is found. The tissue
mask, stain normalization, the featurizer and the kNN run on the card unless
``--device cpu`` is given; asking for the card without one exits 2.
``validate-preprocessing`` reads files on the host and takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from ..utils.device import resolve_device
from ..utils.logging import get_logger, setup_logging

logger = get_logger("cli")

SLIDE_EXTS = (".svs", ".tiff", ".tif", ".ndpi", ".mrxs", ".wsi")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgdm-preprocess")
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the mask, stains, featurizer and kNN run "
                             "(default: the card)")

    ps = sub.add_parser("process-slides", help="slides -> patch HDF5 files")
    ps.add_argument("--input-dir", required=True)
    ps.add_argument("--output-dir", required=True)
    ps.add_argument("--patch-size", type=int, default=256)
    ps.add_argument("--overlap", type=int, default=0)
    ps.add_argument("--tissue-threshold", type=float, default=0.8)
    ps.add_argument("--max-patches", type=int, default=1000)
    ps.add_argument("--magnifications", type=str, default="20.0")
    ps.add_argument("--stain-normalize", action="store_true", default=False)
    ps.add_argument("--stain-method", choices=["macenko", "reinhard"], default="macenko")
    ps.add_argument("--num-workers", type=int, default=4)
    ps.add_argument("--log-level", default="INFO")
    device_flag(ps)

    bg = sub.add_parser("build-graphs", help="patch HDF5 -> graph npz")
    bg.add_argument("--input-dir", required=True, help="dir of *.h5 slide data")
    bg.add_argument("--output-dir", required=True)
    bg.add_argument("--feature-extractor", default="dinov2",
                    choices=["dinov2", "vit_small", "simple_cnn", "none"])
    bg.add_argument("--k-spatial", type=int, default=8)
    bg.add_argument("--k-morphological", type=int, default=16)
    bg.add_argument("--node-buckets", type=str, default="128,256,512,1024,2048")
    bg.add_argument("--feature-batch-size", type=int, default=256)
    bg.add_argument("--spatial-sort", action="store_true", default=False,
                    help="Morton-order nodes (halo SP / windowed spatial attention)")
    bg.add_argument("--knn-window", type=int, default=None,
                    help="restrict kNN edges to the ±1 Morton block band of this "
                         "width (implies --spatial-sort) so that banded model "
                         "compute (model.graph_window) is exact")
    bg.add_argument("--model-config", default=None,
                    help="model yaml the graphs are for: --knn-window from "
                         "model.graph_window and --spatial-sort from the windowed "
                         "settings (as DGDMPredictor derives them)")
    bg.add_argument("--log-level", default="INFO")
    device_flag(bg)

    vp = sub.add_parser("validate-preprocessing", help="check outputs")
    vp.add_argument("--dir", required=True)
    vp.add_argument("--log-level", default="INFO")
    return p


def process_slides(args, device) -> int:
    from ..preprocessing import SlideProcessor
    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    slides = sorted(p for p in in_dir.rglob("*") if p.suffix.lower() in SLIDE_EXTS)
    if not slides:
        logger.error("no slides found in %s", in_dir)
        return 1
    proc = SlideProcessor(
        patch_size=args.patch_size, overlap=args.overlap,
        tissue_threshold=args.tissue_threshold, max_patches=args.max_patches,
        magnifications=[float(m) for m in args.magnifications.split(",")],
        stain_normalize=args.stain_normalize, stain_method=args.stain_method, device=device)

    def work(path: Path):
        target = out_dir / f"{path.stem}.h5"
        if target.exists():
            return path, "skipped"
        data = proc.process_slide(path)
        proc.save_slide_data(data, target)
        return path, f"{data.num_patches} patches"

    ok = failed = 0
    with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
        futures = {pool.submit(work, s): s for s in slides}
        for fut in as_completed(futures):
            try:
                path, status = fut.result()
                logger.info("%s: %s", path.name, status)
                ok += 1
            except Exception as exc:  # noqa: BLE001 - one bad slide does not stop the run
                logger.error("%s failed: %s", futures[fut].name, exc)
                failed += 1
    logger.info("done: %d ok, %d failed", ok, failed)
    return 0 if failed == 0 else 1


def build_graphs(args, device) -> int:
    from ..data.graph_io import save_graph
    from ..preprocessing import SlideProcessor, TissueGraphBuilder
    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(in_dir.glob("*.h5"))
    if not files:
        logger.error("no .h5 slide data in %s", in_dir)
        return 1
    knn_window, spatial_sort = args.knn_window, args.spatial_sort
    if args.model_config is not None:
        # the band build of the target model (DGDMPredictor's derivation)
        from ..utils.config import load_config
        cfg = load_config(args.model_config)
        gw = getattr(cfg.model, "graph_window", None)
        sw = getattr(cfg.model, "spatial_window", None)
        if knn_window is None:
            knn_window = gw
        elif gw is not None and knn_window != gw:
            logger.error("--knn-window %d conflicts with %s model.graph_window=%d",
                         knn_window, args.model_config, gw)
            return 1
        spatial_sort = spatial_sort or bool(gw or sw)
        logger.info("derived from %s: knn_window=%s spatial_sort=%s",
                    args.model_config, knn_window, spatial_sort)
    builder = TissueGraphBuilder(
        feature_extractor=args.feature_extractor,
        k_spatial=args.k_spatial, k_morphological=args.k_morphological,
        node_buckets=[int(b) for b in args.node_buckets.split(",")],
        feature_batch_size=args.feature_batch_size,
        spatial_sort=spatial_sort or knn_window is not None,
        knn_window=knn_window, device=device)
    failed = 0
    for f in files:
        target = out_dir / f"{f.stem}_graph.npz"
        if target.exists():
            continue
        try:
            g = builder.build_graph(SlideProcessor.load_slide_data(f))
            save_graph(g, target)
            logger.info("%s: %d nodes -> %s", f.name, int(g.node_mask.sum()), target.name)
        except Exception as exc:  # noqa: BLE001 - one bad file does not stop the run
            logger.error("%s failed: %s", f.name, exc)
            failed += 1
    return 0 if failed == 0 else 1


def validate_preprocessing(args) -> int:
    from ..data.graph_io import load_graph
    from ..preprocessing import SlideProcessor
    d = Path(args.dir)
    report = {"h5": 0, "h5_bad": 0, "graphs": 0, "graphs_bad": 0}
    for f in sorted(d.rglob("*.h5")):
        try:
            SlideProcessor.load_slide_data(f)
            report["h5"] += 1
        except Exception:  # noqa: BLE001 - a file that does not read counts as bad
            report["h5_bad"] += 1
    for f in sorted(d.rglob("*_graph.npz")):
        try:
            if load_graph(f).num_nodes <= 0:
                raise ValueError("empty graph")
            report["graphs"] += 1
        except Exception:  # noqa: BLE001 - a file that does not load counts as bad
            report["graphs_bad"] += 1
    print(json.dumps(report))
    return 0 if report["h5_bad"] == 0 and report["graphs_bad"] == 0 else 1


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level)
    if args.command == "validate-preprocessing":
        return validate_preprocessing(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(f"{exc} (--device cpu)")
    if args.command == "process-slides":
        return process_slides(args, device)
    return build_graphs(args, device)


if __name__ == "__main__":
    sys.exit(main())
