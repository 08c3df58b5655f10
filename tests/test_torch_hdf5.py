"""The port's HDF5 slides, native chunk reader and slide-data files
(``dgdm_histopath_torch/native/``, ``preprocessing/slide_io.py::
HDF5SlideBackend`` / ``write_hdf5_slide``, ``SlideProcessor.save_slide_data``
/ ``load_slide_data``) against the JAX package's, on the CPU.

Pixels are compared byte for byte (both sides copy bytes through the same
codecs). The JAX side always reads through h5py: ``DGDM_NATIVE_IO=0`` is set
around its calls, so that no test here starts the JAX package's own build of
its native library. The port's native reader is built once per process.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from dgdm_histopath_tpu import native as jnative
from dgdm_histopath_tpu.preprocessing import slide_io as jio
from dgdm_histopath_tpu.preprocessing.slide_processor import (
    PatchInfo as JaxPatchInfo,
    SlideData as JaxSlideData,
    SlideProcessor as JaxProcessor,
)
from dgdm_histopath_torch import native
from dgdm_histopath_torch.preprocessing import slide_io
from dgdm_histopath_torch.preprocessing.slide_processor import PatchInfo, SlideData, SlideProcessor

COMPRESSIONS = [None, "gzip", "lzf"]


@contextlib.contextmanager
def jax_h5py():
    """The JAX package's h5py reader, asked for by its own switch."""
    old = os.environ.get("DGDM_NATIVE_IO")
    os.environ["DGDM_NATIVE_IO"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DGDM_NATIVE_IO"]
        else:
            os.environ["DGDM_NATIVE_IO"] = old


def open_jax(path):
    with jax_h5py():
        return jio.HDF5SlideBackend(path)


def open_port(path, reader="native", monkeypatch=None):
    if reader == "h5py":
        monkeypatch.setenv("DGDM_NATIVE_IO", "0")
    slide = slide_io.HDF5SlideBackend(path)
    if monkeypatch is not None:
        monkeypatch.delenv("DGDM_NATIVE_IO", raising=False)
    return slide


def pyramid(seed=7, w0=777, h0=611, levels=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(levels):
        out.append(rng.integers(0, 255, (h0, w0, 3), dtype=np.uint8))
        w0, h0 = max(1, w0 // 4), max(1, h0 // 4)
    return out


def truth(level, y0, x0, h, w):
    """The in-bounds part of a window, 255 elsewhere."""
    out = np.full((h, w, 3), 255, np.uint8)
    y1, x1 = min(y0 + h, level.shape[0]), min(x0 + w, level.shape[1])
    ys, xs = max(y0, 0), max(x0, 0)
    if y1 > ys and x1 > xs:
        out[ys - y0:y1 - y0, xs - x0:x1 - x0] = level[ys:y1, xs:x1]
    return out


@pytest.fixture(scope="module")
def levels():
    return pyramid()


@pytest.fixture(scope="module", params=COMPRESSIONS, ids=["raw", "gzip", "lzf"])
def slide(request, levels, tmp_path_factory):
    return slide_io.write_hdf5_slide(tmp_path_factory.mktemp("h5") / "s.h5", levels,
                                     properties={"openslide.objective-power": "40"},
                                     tile=128, compression=request.param)


@pytest.mark.parametrize("compression", COMPRESSIONS, ids=["raw", "gzip", "lzf"])
def test_slides_written_by_each_package_read_bit_equal_in_the_other(tmp_path, levels,
                                                                    compression):
    props = {"openslide.objective-power": "20", "k": "v"}
    port_file = slide_io.write_hdf5_slide(tmp_path / "p.h5", levels, props, tile=128,
                                          compression=compression)
    jax_file = jio.write_hdf5_slide(tmp_path / "j.h5", levels, props, tile=128,
                                    compression=compression)
    with h5py.File(port_file) as a, h5py.File(jax_file) as b:
        assert dict(a.attrs) == dict(b.attrs)
        for i in range(len(levels)):
            da, db = a[f"level_{i}"], b[f"level_{i}"]
            assert (da.chunks, da.compression, da.compression_opts) == (
                db.chunks, db.compression, db.compression_opts)
    for path in (port_file, jax_file):
        ours, theirs = slide_io.open_slide(path), open_jax(path)
        assert ours.level_dimensions == theirs.level_dimensions
        assert ours.level_downsamples == theirs.level_downsamples
        assert ours.properties == theirs.properties == props
        for i, lvl in enumerate(levels):
            h, w = lvl.shape[:2]
            ds = ours.level_downsamples[i]
            np.testing.assert_array_equal(ours.read_region((0, 0), i, (w, h)), lvl)
            np.testing.assert_array_equal(theirs.read_region((0, 0), i, (w, h)), lvl)
            loc = (int(64 * ds), int(32 * ds))
            np.testing.assert_array_equal(ours.read_region(loc, i, (40, 30)),
                                          theirs.read_region(loc, i, (40, 30)))
        ours.close(), theirs.close()


def test_native_reader_against_both_h5py_readers(slide, levels, monkeypatch):
    """Interior, chunk-straddling and out-of-bounds windows: the port's
    native reader, its h5py reader and the JAX package's h5py reader agree
    (and the reader counts say which served each read)."""
    nat, h5 = open_port(slide), open_port(slide, "h5py", monkeypatch)
    ref = open_jax(slide)
    w0, h0 = nat.level_dimensions[0]
    windows = [(0, 0), (100, 100), (127, 127), (128, 128), (120, 500), (255, 1), (590, 700),
               (h0 - 20, w0 - 40), (10 ** 6, 10 ** 6)]
    native.reset_reader_counts()
    for y0, x0 in windows:
        got = nat.read_region((x0, y0), 0, (96, 72))
        np.testing.assert_array_equal(got, truth(levels[0], y0, x0, 72, 96))
        np.testing.assert_array_equal(h5.read_region((x0, y0), 0, (96, 72)), got)
        np.testing.assert_array_equal(ref.read_region((x0, y0), 0, (96, 72)), got)
    # a higher level, addressed in level-0 coordinates
    ds = nat.level_downsamples[1]
    np.testing.assert_array_equal(nat.read_region((512, 256), 1, (60, 50)),
                                  truth(levels[1], int(256 / ds), int(512 / ds), 50, 60))
    assert native.reader_counts() == {"native": len(windows) + 1, "h5py": len(windows)}
    for s in (nat, h5, ref):
        s.close()


@pytest.mark.parametrize("origin", [(-50, -30), (-10, 40), (30, -5)])
def test_negative_origin_reads_follow_each_reference_reader(slide, levels, monkeypatch, origin):
    """The JAX readers disagree on a window that starts left of or above the
    level: its h5py ``read_region`` fills the whole window with 255, its
    native reader keeps the part inside. Each port reader matches its JAX
    counterpart: the port's h5py reader the JAX h5py reader, the port's
    native reader the in-bounds truth (the JAX native reader's behaviour,
    ``tests/test_native_io.py::test_out_of_bounds_fill``)."""
    x0, y0 = origin
    nat, h5 = open_port(slide), open_port(slide, "h5py", monkeypatch)
    ref = open_jax(slide)
    want_h5py = ref.read_region(origin, 0, (100, 100))
    assert (want_h5py == 255).all()
    np.testing.assert_array_equal(h5.read_region(origin, 0, (100, 100)), want_h5py)
    got = nat.read_region(origin, 0, (100, 100))
    np.testing.assert_array_equal(got, truth(levels[0], y0, x0, 100, 100))
    assert (got != 255).any()
    # both batch readers keep the in-bounds part, as JAX's h5py read_regions
    np.testing.assert_array_equal(h5.read_regions([origin], 0, (100, 100))[0], got)
    np.testing.assert_array_equal(ref.read_regions([origin], 0, (100, 100))[0], got)
    for s in (nat, h5, ref):
        s.close()


def test_banded_read_regions_match(slide, levels, monkeypatch):
    """Random, repeated-row and sparse locations (the strip split at gaps of
    more than 2 patch widths), some out of bounds."""
    rng = np.random.default_rng(3)
    locs = [(int(x), int(y)) for x, y in zip(rng.integers(-64, 800, 30),
                                             rng.integers(-64, 640, 30))]
    locs += [(0, 200), (64, 200), (600, 200), (700, 200), (-30, 600)]
    nat, h5 = open_port(slide), open_port(slide, "h5py", monkeypatch)
    ref = open_jax(slide)
    native.reset_reader_counts()
    got = nat.read_regions(locs, 0, (64, 48))
    for g, (x0, y0) in zip(got, locs):
        np.testing.assert_array_equal(g, truth(levels[0], y0, x0, 48, 64))
    np.testing.assert_array_equal(h5.read_regions(locs, 0, (64, 48)), got)
    np.testing.assert_array_equal(ref.read_regions(locs, 0, (64, 48)), got)
    assert native.reader_counts() == {"native": 1, "h5py": 1}
    # the processor's batch read over an HDF5 slide: the port's as JAX's
    infos = [PatchInfo(x, y, 0, 40.0, 64, 1.0) for x, y in locs[:8]]
    jinfos = [JaxPatchInfo(x, y, 0, 40.0, 64, 1.0) for x, y in locs[:8]]
    proc = SlideProcessor(patch_size=64, stain_normalize=False, device="cpu")
    np.testing.assert_array_equal(
        proc.extract_patch_batch(nat, infos),
        JaxProcessor(patch_size=64, stain_normalize=False).extract_patch_batch(ref, jinfos))
    for s in (nat, h5, ref):
        s.close()


def test_advise_regions_then_read(slide, levels):
    nat = open_port(slide)
    locs = [(0, 0), (300, 200), (700, 550), (-20, -20), (10 ** 6, 10 ** 6)]
    nat.advise_regions(locs, 0, (128, 96))
    nat.advise_regions([], 0, (64, 64))
    got = nat.read_regions(locs, 0, (128, 96))
    for g, (x0, y0) in zip(got, locs):
        np.testing.assert_array_equal(g, truth(levels[0], y0, x0, 96, 128))
    nat.close()
    slide_io.ArrayBackend([np.zeros((64, 64, 3), np.uint8)]).advise_regions([(0, 0)], 0, (8, 8))


ELIGIBILITY = {
    "raw": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3)), True),
    "gzip": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3),
                  compression="gzip"), True),
    "lzf": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3),
                 compression="lzf"), True),
    "float32": (dict(data=np.zeros((64, 64, 3), np.float32), chunks=(32, 32, 3)), False),
    "shuffle": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3),
                     compression="gzip", shuffle=True), False),
    "fletcher32": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3),
                        fletcher32=True), False),
    "scaleoffset": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 3),
                         scaleoffset=4), False),
    "contiguous": (dict(data=np.zeros((64, 64, 3), np.uint8)), False),
    "4 channels": (dict(data=np.zeros((64, 64, 4), np.uint8), chunks=(32, 32, 4)), False),
    "channel chunks": (dict(data=np.zeros((64, 64, 3), np.uint8), chunks=(32, 32, 1)), False),
}


@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_chunk_index_eligibility_is_jaxs(tmp_path, case):
    kw, eligible = ELIGIBILITY[case]
    path = tmp_path / "d.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("d", **kw)
    with h5py.File(path, "r") as f:
        ours = native.ChunkIndex.from_dataset(f["d"])
        theirs = jnative.ChunkIndex.from_dataset(f["d"])   # no build: h5py only
    assert (ours is not None) == (theirs is not None) == eligible
    if eligible:
        for k in ("lvl_h", "lvl_w", "ch", "cw", "comp"):
            assert getattr(ours, k) == getattr(theirs, k)
        for k in ("offsets", "nbytes", "fmask"):
            np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k))


def test_an_ineligible_level_reads_through_h5py(tmp_path, levels):
    """A shuffled level is a format the native reader does not take: that
    level reads through h5py, the others natively."""
    path = tmp_path / "mixed.h5"
    with h5py.File(path, "w") as f:
        f.attrs["dgdm_wsi"] = "1"
        f.create_dataset("level_0", data=levels[0], chunks=(128, 128, 3), compression="gzip",
                         shuffle=True)
        f.create_dataset("level_1", data=levels[1], chunks=(64, 64, 3), compression="gzip")
    s = slide_io.open_slide(path)
    native.reset_reader_counts()
    np.testing.assert_array_equal(s.read_region((10, 20), 0, (50, 40)), levels[0][20:60, 10:60])
    np.testing.assert_array_equal(s.read_region((0, 0), 1, (30, 20)), levels[1][:20, :30])
    assert native.reader_counts() == {"native": 1, "h5py": 1}
    s.close()


def test_unallocated_chunks_read_hdf5s_fill(tmp_path):
    path = tmp_path / "sparse.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", shape=(512, 512, 3), dtype=np.uint8, chunks=(256, 256, 3))
        d[:256, :256] = 7                    # one of four chunks allocated
    with h5py.File(path, "r") as f:
        idx = native.ChunkIndex.from_dataset(f["d"])
        want = [f["d"][200:328, 200:328], f["d"][300:428, 300:428]]
    got = idx.read_patches(str(path), [200, 300], [200, 300], 128, 128)
    np.testing.assert_array_equal(got[0], want[0])       # h5py reads the default fill, 0
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][:56, :56] == 7).all() and (got[1] == 0).all()


@pytest.mark.parametrize("compression", ["gzip", "lzf"])
def test_a_corrupt_chunk_raises(tmp_path, compression):
    """A chunk that does not inflate raises the reader's error through the
    backend: no quiet fallback to h5py (which the JAX backend takes)."""
    path = tmp_path / "corrupt.h5"
    # compressible pixels: h5py stores incompressible LZF chunks unfiltered
    slide_io.write_hdf5_slide(path, [np.full((300, 280, 3), 7, np.uint8)], tile=128,
                              compression=compression)
    with h5py.File(path, "r") as f:
        info = f["level_0"].id.get_chunk_info(0)
    with open(path, "r+b") as f:
        f.seek(info.byte_offset)
        f.write(bytes([0xFF] * min(info.size, 64)))
    s = slide_io.open_slide(path)
    with pytest.raises(RuntimeError, match="chunk decompression failed"):
        s.read_region((0, 0), 0, (64, 64))
    with pytest.raises(RuntimeError, match="chunk decompression failed"):
        s.read_regions([(200, 200), (0, 0)], 0, (64, 64))
    s.close()


def test_decoded_chunk_cache_hits_and_evictions(tmp_path, monkeypatch):
    lvl = np.add.outer(np.arange(700) % 251, np.arange(600) % 241)[..., None]
    lvl = np.repeat(lvl.astype(np.uint8), 3, axis=2)
    paths = {c: slide_io.write_hdf5_slide(tmp_path / f"g_{c}.h5", [lvl], tile=128,
                                          compression=c) for c in (None, "gzip", "lzf")}
    with h5py.File(paths["gzip"]) as f:
        idx = native.ChunkIndex.from_dataset(f["level_0"])
    ys, xs = [0, 300, 500], [0, 200, 400]
    a = idx.read_patches(paths["gzip"], ys, xs, 128, 128)
    h0, m0, b0 = idx.cache_stats()
    assert h0 == 0 and m0 > 0 and b0 > 0
    b = idx.read_patches(paths["gzip"], ys, xs, 128, 128)
    assert idx.cache_stats()[:2] == (m0, m0)             # the same call again: all hits
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0], lvl[:128, :128])
    # a 1 MB budget holds ~21 of the 30 decoded chunks: every sweep evicts
    monkeypatch.setattr(native.ChunkIndex, "CACHE_MB_DEFAULT", 1)
    with h5py.File(paths["lzf"]) as f:
        small = native.ChunkIndex.from_dataset(f["level_0"])
    ys = [y for y in range(0, 700, 128) for _ in range(0, 600, 128)]
    xs = [x for _ in range(0, 700, 128) for x in range(0, 600, 128)]
    for _ in range(3):
        got = small.read_patches(paths["lzf"], ys, xs, 128, 128)
    assert small.cache_stats()[2] <= 1 << 20
    for (y, x), patch in zip(zip(ys, xs), got):
        np.testing.assert_array_equal(patch, truth(lvl, y, x, 128, 128))
    with h5py.File(paths[None]) as f:                    # raw datasets do not cache
        raw = native.ChunkIndex.from_dataset(f["level_0"])
    raw.read_patches(paths[None], [0], [0], 128, 128)
    assert raw.cache_stats() == (0, 0, 0)


def test_native_io_0_asks_for_the_h5py_reader(slide, levels, monkeypatch):
    monkeypatch.setenv("DGDM_NATIVE_IO", "0")
    s = slide_io.open_slide(slide)
    native.reset_reader_counts()
    s.read_regions([(0, 0), (100, 90)], 0, (32, 32))
    s.read_region((5, 5), 0, (32, 32))
    s.advise_regions([(0, 0)], 0, (32, 32))              # nothing to advise
    assert native.reader_counts() == {"native": 0, "h5py": 2}
    s.close()


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "dgdm_io.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native chunk reader failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))     # no library, no temporary left


_BUILD_SCRIPT = """
import importlib.util, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("native_under_test", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.BUILD_DIR = Path(sys.argv[2])
print(mod.get_lib().dgdm_io_version())
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Each build compiles to a name of its own and is renamed into place:
    two processes that start the build together both load the library (the
    JAX package's shared ``.so.tmp`` lets one of them fail)."""
    build_dir = tmp_path / "build"
    script = tmp_path / "build_once.py"
    script.write_text(_BUILD_SCRIPT)
    src = str(Path(native.__file__))
    procs = [subprocess.Popen([sys.executable, str(script), src, str(build_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    assert [o[0].strip() for o in outs] == ["3", "3"]
    assert [p.name for p in build_dir.iterdir()] == [native.library_path().name]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_slide_data_round_trip_in_both_directions(tmp_path, writer):
    rng = np.random.default_rng(5)
    patches = rng.integers(0, 255, (4, 16, 16, 3), dtype=np.uint8)
    mask = rng.random((12, 10)) > 0.5
    rows = [(0, 16, 0, 20.0, 16, 0.9), (48, 16, 1, 10.0, 16, 0.75), (2 ** 40, 7, 2, 5.0, 16, 1.0),
            (3, 5, 0, 40.0, 16, 0.8125)]
    meta = {"path": "/x/s.tif", "dimensions": [160, 120], "objective_power": 20.0,
            "magnifications": [20.0, 10.0], "num_patches": 4}
    if writer == "port":
        data = SlideData("s1", "/x/s.tif", patches, [PatchInfo(*r) for r in rows], meta, mask)
        path = SlideProcessor.save_slide_data(data, tmp_path / "s1.h5")
        back = JaxProcessor.load_slide_data(path)
        cls = JaxPatchInfo
    else:
        data = JaxSlideData("s1", "/x/s.tif", patches, [JaxPatchInfo(*r) for r in rows], meta,
                            mask)
        path = JaxProcessor.save_slide_data(data, tmp_path / "s1.h5")
        back = SlideProcessor.load_slide_data(path)
        cls = PatchInfo
    assert (back.slide_id, back.slide_path, back.metadata) == ("s1", "/x/s.tif", meta)
    np.testing.assert_array_equal(back.patches, patches)
    np.testing.assert_array_equal(back.tissue_mask, mask)
    assert back.patch_info == [cls(*[np.float32(v).item() if isinstance(v, float) else v
                                     for v in r]) for r in rows]
    with h5py.File(path) as f:
        assert f["patches"].compression == "gzip" and f["patches"].compression_opts == 4
        assert f["tissue_mask"].dtype == np.uint8
        assert f["patch_info"].dtype.names == ("x", "y", "level", "magnification", "size",
                                               "tissue_fraction")
    # no mask: the dataset is left out and reads back as None
    data.tissue_mask = None
    save = SlideProcessor.save_slide_data if writer == "port" else JaxProcessor.save_slide_data
    load = JaxProcessor.load_slide_data if writer == "port" else SlideProcessor.load_slide_data
    assert load(save(data, tmp_path / "s2.h5")).tissue_mask is None
