"""``python -m dgdm_histopath_torch.cli.preprocess`` (``dgdm-preprocess``),
``SlideDataset.preprocess_all(num_workers > 1)`` and
``utils/distributed_processing.py`` against the JAX package's, on the CPU.

Two small deflate-tiled TIFF slides (512², 20x) go through both CLIs with
32-px patches: the ``.h5`` slide-data files are equal field for field, the
graphs (``--feature-extractor none``, with and without a windowed
``--model-config``) slot for slot (features and positions equal, edge
features within 1e-5), the validate JSON and the exit codes equal. The JAX
side runs with ``DGDM_NATIVE_IO=0`` (no build of its native library).

One exception to slot for slot: two morphological neighbours that tie in
exact arithmetic (mirrored placeholder features, x and y swapped). The
reference orders them by its f32 rounding, and XLA's CPU dot rounds a 5-d
product by a strategy that depends on the shape: at N = 300 a chain of
fused multiply-adds in order (what ``ops/knn.py`` reproduces,
``tests/test_torch_knn.py``), at these buckets (N 32, 64) two interleaved
chains (dimensions 0, 2, 4 and 1, 3) added at the end. Such a pair may stand
in the other order; the test checks that every slot that differs is one of
these exact ties, the pair swapped, and that they are under 1% of the slots.
"""

import contextlib
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

from dgdm_histopath_tpu.cli import preprocess as jcli
from dgdm_histopath_tpu.data import dataset as jds
from dgdm_histopath_tpu.preprocessing.slide_processor import SlideProcessor as JaxProcessor
from dgdm_histopath_tpu.preprocessing.tissue_graph_builder import (
    TissueGraphBuilder as JaxBuilder,
)
from dgdm_histopath_tpu.utils import distributed_processing as jdp
from dgdm_histopath_torch.cli import preprocess as cli
from dgdm_histopath_torch.data import SlideDataset, load_graph
from dgdm_histopath_torch.preprocessing import SlideProcessor, TissueGraphBuilder, synthetic
from dgdm_histopath_torch.preprocessing.tiff import write_tiled_tiff
from dgdm_histopath_torch.utils import distributed_processing as dp

GRAPH_FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")
PROCESS = ["--patch-size", "32", "--max-patches", "30", "--tissue-threshold", "0.3",
           "--num-workers", "2"]
BUILD = ["--feature-extractor", "none", "--node-buckets", "32,64"]


@contextlib.contextmanager
def loggers_put_back():
    """``main`` calls ``setup_logging``, which points the package loggers at
    this test's stderr: put them back after each call."""
    loggers = [logging.getLogger(n) for n in ("dgdm_histopath_torch", "dgdm_histopath_tpu")]
    saved = [(lg.level, lg.propagate, list(lg.handlers)) for lg in loggers]
    try:
        yield
    finally:
        for lg, (level, propagate, handlers) in zip(loggers, saved):
            lg.setLevel(level)
            lg.propagate = propagate
            lg.handlers[:] = handlers


def run_jax(argv):
    old = os.environ.get("DGDM_NATIVE_IO")
    os.environ["DGDM_NATIVE_IO"] = "0"
    try:
        with loggers_put_back():
            return jcli.main(argv)
    finally:
        if old is None:
            del os.environ["DGDM_NATIVE_IO"]
        else:
            os.environ["DGDM_NATIVE_IO"] = old


def run_port(argv, device=True):
    with loggers_put_back():
        return cli.main(argv + (["--device", "cpu"] if device else []))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    for s in (31, 32):
        img, _ = synthetic.generate_tissue_image(512, 512, seed=s)
        write_tiled_tiff(d / "slides" / f"slide{s}.tif", synthetic.build_pyramid(img, 3),
                         tile=128, compression="deflate", description="Aperio S|AppMag = 20")
    (d / "model.yaml").write_text("model:\n  graph_window: 16\n  spatial_window: 16\n")
    codes = {}
    for side, run in (("port", run_port), ("jax", run_jax)):
        codes[side, "process"] = run(["process-slides", "--input-dir", str(d / "slides"),
                                      "--output-dir", str(d / side / "h5"), *PROCESS])
        codes[side, "build"] = run(["build-graphs", "--input-dir", str(d / side / "h5"),
                                    "--output-dir", str(d / side / "graphs"), *BUILD])
        codes[side, "band"] = run(["build-graphs", "--input-dir", str(d / side / "h5"),
                                   "--output-dir", str(d / side / "band"), *BUILD,
                                   "--model-config", str(d / "model.yaml")])
    return d, codes


def npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_process_slides_writes_the_jax_slide_data(root):
    d, codes = root
    assert codes["port", "process"] == codes["jax", "process"] == 0
    names = sorted(p.name for p in (d / "jax" / "h5").iterdir())
    assert names == sorted(p.name for p in (d / "port" / "h5").iterdir()) == [
        "slide31.h5", "slide32.h5"]
    for name in names:
        a = JaxProcessor.load_slide_data(d / "port" / "h5" / name)
        b = JaxProcessor.load_slide_data(d / "jax" / "h5" / name)
        assert (a.slide_id, a.slide_path, a.metadata) == (b.slide_id, b.slide_path, b.metadata)
        assert a.patch_info == b.patch_info and 0 < len(a.patch_info) <= 30
        np.testing.assert_array_equal(a.patches, b.patches)
        np.testing.assert_array_equal(a.tissue_mask, b.tissue_mask)


def exact_tie_swaps(a, b) -> int:
    """Slots of ``nbr_idx`` that differ between two graphs; each must be a
    morphological slot whose two candidates tie in exact arithmetic (f64
    cosine), with the row's neighbours the same set."""
    idx_a, idx_b = a["nbr_idx"], b["nbr_idx"]
    x = a["x"].astype(np.float64)
    unit = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    rows, cols = np.nonzero(idx_a != idx_b)
    for r, c in zip(rows, cols):
        assert c >= 8, ("a spatial slot differs", r, c)
        assert sorted(idx_a[r]) == sorted(idx_b[r])
        assert abs(unit[r] @ unit[idx_a[r, c]] - unit[r] @ unit[idx_b[r, c]]) < 1e-12
    return len(rows)


@pytest.mark.parametrize("out", ["graphs", "band"])
def test_build_graphs_equal_slot_for_slot(root, out):
    d, codes = root
    key = "build" if out == "graphs" else "band"
    assert codes["port", key] == codes["jax", key] == 0
    names = sorted(p.name for p in (d / "jax" / out).iterdir())
    assert names == sorted(p.name for p in (d / "port" / out).iterdir()) == [
        "slide31_graph.npz", "slide32_graph.npz"]
    swapped = slots = 0
    for name in names:
        a, b = npz(d / "port" / out / name), npz(d / "jax" / out / name)
        for f in GRAPH_FIELDS:
            if f == "edge_attr":
                np.testing.assert_allclose(a[f], b[f], atol=1e-5, rtol=0, err_msg=f)
            elif f != "nbr_idx":
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        swapped += exact_tie_swaps(a, b)
        slots += a["nbr_idx"].size
        assert load_graph(d / "port" / out / name).num_nodes == a["x"].shape[0]
    assert swapped <= 0.01 * slots
    if out == "band":            # Morton order: the graphs differ from the plain build
        plain = npz(d / "port" / "graphs" / names[0])
        assert not np.array_equal(plain["pos"], npz(d / "port" / "band" / names[0])["pos"])


def test_validate_preprocessing_reports_as_jax(root, capsys):
    d, _ = root
    for sub in ("port", "jax"):
        capsys.readouterr()
        assert run_port(["validate-preprocessing", "--dir", str(d / sub)], device=False) == 0
        ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert run_jax(["validate-preprocessing", "--dir", str(d / sub)]) == 0
        theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert ours == theirs == {"h5": 2, "h5_bad": 0, "graphs": 4, "graphs_bad": 0}


def test_process_slides_keeps_existing_outputs(root):
    d, _ = root
    target = d / "port" / "h5" / "slide31.h5"
    before = target.stat().st_mtime_ns
    assert run_port(["process-slides", "--input-dir", str(d / "slides"),
                     "--output-dir", str(d / "port" / "h5"), *PROCESS]) == 0
    assert target.stat().st_mtime_ns == before


def _broken_dirs(d):
    (d / "empty").mkdir(exist_ok=True)
    bad = d / "bad"
    (bad / "slides").mkdir(parents=True, exist_ok=True)
    (bad / "slides" / "broken.tif").write_bytes(b"not a tiff")
    (bad / "h5").mkdir(exist_ok=True)
    (bad / "h5" / "broken.h5").write_bytes(b"not hdf5")
    return d / "empty", bad


# (output dir, the module's root, an empty dir, a dir of broken files) -> argv
EXIT_CASES = {
    "no slides": lambda t, r, e, b: ["process-slides", "--input-dir", str(e),
                                     "--output-dir", str(t / "o1")],
    "a broken slide": lambda t, r, e, b: ["process-slides", "--input-dir", str(b / "slides"),
                                          "--output-dir", str(t / "o2"), *PROCESS],
    "no slide data": lambda t, r, e, b: ["build-graphs", "--input-dir", str(e),
                                         "--output-dir", str(t / "o3"), *BUILD],
    "broken slide data": lambda t, r, e, b: ["build-graphs", "--input-dir", str(b / "h5"),
                                             "--output-dir", str(t / "o4"), *BUILD],
    "window conflict": lambda t, r, e, b: ["build-graphs", "--input-dir", str(r / "port" / "h5"),
                                           "--output-dir", str(t / "o5"), *BUILD,
                                           "--model-config", str(r / "model.yaml"),
                                           "--knn-window", "8"],
    "invalid file": lambda t, r, e, b: ["validate-preprocessing", "--dir", str(b)],
}


@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_exit_codes_are_jaxs(root, tmp_path, case, capsys):
    d, _ = root
    argv = EXIT_CASES[case](tmp_path, d, *_broken_dirs(d))
    ours = run_port(argv, device=argv[0] != "validate-preprocessing")
    port_out = capsys.readouterr().out
    theirs = run_jax(argv)
    assert ours == theirs == 1
    if case == "window conflict":               # the files are there: the conflict refused
        assert not (tmp_path / "o5").exists() or not list((tmp_path / "o5").iterdir())
    if case == "invalid file":
        assert json.loads(port_out) == json.loads(capsys.readouterr().out) == {
            "h5": 0, "h5_bad": 1, "graphs": 0, "graphs_bad": 0}


@pytest.mark.parametrize("sub", ["process-slides", "build-graphs"])
def test_no_card_and_no_device_cpu_exits_2(root, tmp_path, sub):
    d, _ = root
    with pytest.raises(SystemExit) as exc, loggers_put_back():
        cli.main([sub, "--input-dir", str(d / "slides"), "--output-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert not list(tmp_path.iterdir())


SLIDE_KW = dict(patch_size=32, max_patches=30, tissue_threshold=0.3)


def test_preprocess_all_two_workers_equals_one_and_jax(root, tmp_path):
    """Graphs of the ``"stats"`` featurizer: two workers write what one
    writes, bit for bit; the JAX package's two workers the same neighbour
    lists and masks, features and edge features within 1e-5."""
    d, _ = root
    paths = sorted((d / "slides").glob("*.tif")) + [d / "bad" / "slides" / "broken.tif"]
    _broken_dirs(d)

    def port_dataset():
        return SlideDataset(paths, SlideProcessor(stain_normalize=False, device="cpu",
                                                  **SLIDE_KW),
                            TissueGraphBuilder("stats", node_buckets=[32, 64], device="cpu"))

    one = port_dataset().preprocess_all(tmp_path / "one", num_workers=1)
    two = port_dataset().preprocess_all(tmp_path / "two", num_workers=2)
    ref = jds.SlideDataset(paths, JaxProcessor(stain_normalize=False, **SLIDE_KW),
                           JaxBuilder("stats", node_buckets=[32, 64])).preprocess_all(
                               tmp_path / "jax", num_workers=2)
    assert [p.name for p in one] == [p.name for p in two] == [p.name for p in ref] == [
        "slide31_graph.npz", "slide32_graph.npz"]              # the broken slide left out
    for a, b, c in zip(one, two, ref):
        a, b, c = npz(a), npz(b), npz(c)
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
            if a[f].dtype.kind == "f":
                np.testing.assert_allclose(a[f], c[f], atol=1e-5, rtol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(a[f], c[f], err_msg=f)


def _balancer_trace(mod, strategy):
    lb = mod.IntelligentLoadBalancer(strategy)
    for i, cap in enumerate((2, 4, 1)):
        lb.register(f"n{i}", capacity=cap)
    picks = []
    for step in range(14):
        node = lb.select()
        node.active += 1
        picks.append(node.node_id)
        if step % 3 == 2:
            lb.record(node, ok=step % 2 == 0, latency_s=0.01 * (int(node.node_id[1]) + 1))
    return picks, lb.status()


@pytest.mark.parametrize("strategy", ["least_loaded", "round_robin", "fastest"])
def test_balancer_picks_nodes_as_jax(strategy):
    assert _balancer_trace(dp, strategy) == _balancer_trace(jdp, strategy)
    for mod in (dp, jdp):
        with pytest.raises(ValueError, match="unknown strategy"):
            mod.IntelligentLoadBalancer("random")
        with pytest.raises(RuntimeError, match="no worker nodes"):
            mod.IntelligentLoadBalancer().select()


def _scheduler_trace(mod):
    """One worker, held busy while tasks of several priorities queue: the
    order they run in, and the failed task's error."""
    started, gate, order = threading.Event(), threading.Event(), []
    with mod.DistributedTaskScheduler(num_workers=1) as sched:
        sched.submit(lambda: (started.set(), gate.wait(5)), priority=100)
        assert started.wait(5)
        futures = [sched.submit(order.append, label, priority=p)
                   for label, p in (("a", 1), ("b", 5), ("c", 9), ("d", 5), ("e", 1), ("f", 9))]
        failed = sched.submit(lambda: 1 / 0, priority=0)
        gate.set()
        for f in futures:
            f.result(5)
        error = type(failed.exception(5)).__name__
        time.sleep(0.05)                    # the worker records the failure
        status = sched.balancer.status()["worker0"]
    return order, error, status["completed"], status["failed"]


def test_scheduler_runs_by_priority_then_submission_as_jax():
    assert _scheduler_trace(dp) == _scheduler_trace(jdp) == (
        ["c", "f", "b", "d", "a", "e"], "ZeroDivisionError", 7, 1)


def test_process_batch_cluster_and_decorator_match_jax():
    items = list(range(11))
    for mod in (dp, jdp):
        assert mod.process_batch(lambda x: x * x, items, num_workers=3) == [x * x for x in items]
        assert mod.process_batch(lambda x: -x, items, num_workers=2, chunk_size=4) == [
            -x for x in items]
        with pytest.raises(ValueError, match="bad item"):
            mod.process_batch(lambda x: (_ for _ in ()).throw(ValueError("bad item"))
                              if x == 5 else x, items, num_workers=2)
        with mod.create_local_cluster(num_workers=2, strategy="round_robin") as cluster:
            assert cluster.map(str, items) == [str(x) for x in items]
            assert sum(s["completed"] for s in cluster.status().values()) == len(items)

        @mod.distributed_task(priority=7)
        def add(a, b=1):
            return a + b
        assert add(2, b=3).result(5) == 5 and add.sync(2) == 3
