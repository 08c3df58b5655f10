"""The port's slide reading, writing and patch grid
(``dgdm_histopath_torch/preprocessing/{tiff,slide_io,synthetic,slide_processor}.py``)
against the JAX package's, on the CPU. Pixels are compared byte for byte:
both sides are the same integer arithmetic and the same codecs."""

import os
import zlib

import numpy as np
import pytest

from dgdm_histopath_tpu.preprocessing import slide_io as jio
from dgdm_histopath_tpu.preprocessing import synthetic as jsyn
from dgdm_histopath_tpu.preprocessing import tiff as jtiff
from dgdm_histopath_tpu.preprocessing.slide_processor import SlideProcessor as JaxProcessor
from dgdm_histopath_torch.preprocessing import slide_io, synthetic, tiff
from dgdm_histopath_torch.preprocessing.slide_processor import (
    PatchInfo,
    SlideProcessor,
    _decode_patches_worker,
    _decode_worker_init,
)
from dgdm_histopath_torch.utils.exceptions import SlideProcessingError

REGIONS = [((0, 0), 0, (300, 200)), ((250, 130), 0, (256, 256)), ((600, 500), 1, (100, 90)),
           ((-20, 900), 0, (64, 200)), ((1000, 1000), 2, (40, 40))]


def _pyramid(seed=2, size=1024):
    img, _ = synthetic.generate_tissue_image(size, size - 64, seed=seed)
    return synthetic.build_pyramid(img, 3)


@pytest.mark.parametrize("compression,bigtiff,size", [("raw", False, 1024),
                                                      ("deflate", True, 1024),
                                                      ("lzw", False, 192)])
def test_port_writer_is_read_by_both_readers(tmp_path, compression, bigtiff, size):
    """(LZW is pure Python, ~20 kB/s: a small slide and small tiles.)"""
    levels = _pyramid(size=size)
    tile = 256 if size > 256 else 64
    path = tiff.write_tiled_tiff(tmp_path / "s.tif", levels, tile=tile, compression=compression,
                                 bigtiff=bigtiff, description="Aperio X|AppMag = 20|MPP = 0.5")
    port, ref = slide_io.TiledTiffBackend(path), jio.TiledTiffBackend(path)
    try:
        assert port.level_dimensions == ref.level_dimensions
        assert port.properties == ref.properties
        assert port.properties["openslide.objective-power"] == "20"
        for loc, level, size in REGIONS:
            a = port.read_region(loc, level, size)
            np.testing.assert_array_equal(a, ref.read_region(loc, level, size))
        x0, y0 = 50, 30
        np.testing.assert_array_equal(port.read_region((x0, y0), 0, (100, 90)),
                                      levels[0][y0:y0 + 90, x0:x0 + 100])
    finally:
        port.close(), ref.close()


def test_jax_writer_file_is_read_by_the_port(tmp_path):
    levels = _pyramid(seed=4)
    path = jtiff.write_tiled_tiff(tmp_path / "j.tif", levels, tile=128, compression="deflate",
                                  bigtiff=True)
    port, ref = slide_io.TiledTiffBackend(path), jio.TiledTiffBackend(path)
    try:
        for loc, level, size in REGIONS:
            np.testing.assert_array_equal(port.read_region(loc, level, size),
                                          ref.read_region(loc, level, size))
        np.testing.assert_array_equal(port.get_thumbnail(128), ref.get_thumbnail(128))
    finally:
        port.close(), ref.close()


def test_streaming_writer_writes_the_same_file_as_the_jax_writer(tmp_path):
    levels = _pyramid(seed=5)
    paths = []
    for mod, name in ((tiff, "p.tif"), (jtiff, "j.tif")):
        w = mod.StreamingTiledTiffWriter(tmp_path / name, [lv.shape[:2] for lv in levels],
                                         tile=256, compression="deflate", description="d")
        for lvl, arr in enumerate(levels):
            for ty in range(0, arr.shape[0], 256):
                for tx in range(0, arr.shape[1], 256):
                    w.write_tile(lvl, arr[ty:ty + 256, tx:tx + 256])
        paths.append(w.close())
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_codecs_match_the_jax_codecs():
    rs = np.random.RandomState(0)
    data = bytes(rs.randint(0, 4, 5000).astype(np.uint8)) + b"\x07" * 3000
    enc = tiff._lzw_encode(data)
    assert enc == jtiff._lzw_encode(data)
    assert tiff._lzw_decode(enc) == data == jtiff._lzw_decode(enc)
    packed = bytes([2, 1, 2, 3, 254, 9, 128, 0, 5])       # literal run, repeat, no-op, literal
    assert tiff._packbits_decode(packed) == jtiff._packbits_decode(packed) == \
        b"\x01\x02\x03" + b"\x09" * 3 + b"\x05"
    page = tiff.TiffPage(4, 2, 4, 2, np.zeros(1), np.zeros(1), compression=8, predictor=2)
    raw = zlib.compress(np.arange(24, dtype=np.uint8).tobytes())
    np.testing.assert_array_equal(tiff._decode_tile(page, raw, 2, 4),
                                  jtiff._decode_tile(page, raw, 2, 4))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, nuclei_density=0.004),
                                dict(seed=1, focal_density=0.01, focal_frac=0.1,
                                     stain_jitter=0.15, brightness_jitter=0.08,
                                     noise_sigma=4.0, nuclei_radius=2)])
def test_generate_tissue_image_is_bit_equal_to_jax(kw):
    img, mask = synthetic.generate_tissue_image(320, 256, **kw)
    ref_img, ref_mask = jsyn.generate_tissue_image(320, 256, **kw)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(mask, ref_mask)
    for a, b in zip(synthetic.build_pyramid(img, 4), jsyn.build_pyramid(ref_img, 4)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_slide_tiff_is_the_jax_file(tmp_path):
    """The numpy band renderer and the streaming writer: the same bytes as
    the JAX package's numpy path."""
    kw = dict(width=1024, height=1024, num_levels=3, band=512, seed=3,
              compression="deflate", num_blobs=6)
    port = synthetic.write_synthetic_slide_tiff(tmp_path / "p.tif", device="numpy", **kw)
    ref = jsyn.write_synthetic_slide_tiff(tmp_path / "j.tif", device="numpy", **kw)
    assert port.read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError, match="divide"):
        synthetic.write_synthetic_slide_tiff(tmp_path / "bad.tif", width=1000, height=1024)


def test_array_backend_and_synthetic_slide_match_jax():
    port, mask = synthetic.synthetic_slide(512, 384, num_levels=3, seed=5)
    ref, ref_mask = jsyn.synthetic_slide(512, 384, num_levels=3, seed=5)
    np.testing.assert_array_equal(mask, ref_mask)
    assert port.level_dimensions == ref.level_dimensions
    assert port.level_downsamples == ref.level_downsamples
    assert port.properties == ref.properties
    for loc, level, size in REGIONS:
        np.testing.assert_array_equal(port.read_region(loc, level, size),
                                      ref.read_region(loc, level, size))
    np.testing.assert_array_equal(port.get_thumbnail(100), ref.get_thumbnail(100))
    np.testing.assert_array_equal(port.read_regions([(0, 0), (64, 32)], 1, (50, 40)),
                                  ref.read_regions([(0, 0), (64, 32)], 1, (50, 40)))
    assert port.best_level_for_downsample(3.0) == ref.best_level_for_downsample(3.0) == 1
    assert port.clone() is port


def test_open_slide(tmp_path):
    path = tiff.write_tiled_tiff(tmp_path / "s.tif", _pyramid(), compression="deflate")
    slide = slide_io.open_slide(path)
    assert isinstance(slide, slide_io.TiledTiffBackend)
    slide.close()
    backend = slide_io.ArrayBackend([np.zeros((8, 8, 3), np.uint8)])
    assert slide_io.open_slide(backend) is backend
    with pytest.raises(SlideProcessingError, match="not found"):
        slide_io.open_slide(tmp_path / "absent.tif")
    # dgdm_wsi HDF5 slides open under each of their suffixes
    levels = _pyramid(size=256)
    for suffix in (".h5", ".hdf5", ".wsi"):
        h5 = slide_io.write_hdf5_slide(tmp_path / f"s{suffix}", levels, tile=128)
        slide = slide_io.open_slide(h5)
        assert isinstance(slide, slide_io.HDF5SlideBackend)
        np.testing.assert_array_equal(slide.read_region((0, 0), 0, (64, 48)), levels[0][:48, :64])
        slide.close()


@pytest.mark.parametrize("mag,overlap,threshold", [(20.0, 0, 0.8), (10.0, 16, 0.5),
                                                   (5.0, 0, 0.3)])
def test_generate_patch_coordinates_match_jax(mag, overlap, threshold):
    backend, _ = synthetic.synthetic_slide(1024, 896, num_levels=3, seed=7)
    kw = dict(patch_size=64, overlap=overlap, tissue_threshold=threshold,
              magnifications=[mag], stain_normalize=False)
    port = SlideProcessor(**kw, device="cpu")
    ref = JaxProcessor(**kw)
    mask, ds = ref.detect_tissue_regions(backend)
    out = port.generate_patch_coordinates(backend, mask, ds)
    want = ref.generate_patch_coordinates(backend, mask, ds)
    assert len(out) == len(want) > 0
    assert [vars(p) for p in out] == [vars(p) for p in want]
    port_mask, port_ds = port.detect_tissue_regions(backend)
    assert port_ds == ds and (port_mask != mask).mean() <= 5e-4
    np.testing.assert_array_equal(port.extract_patch_batch(backend, out[:20]),
                                  ref.extract_patch_batch(backend, want[:20]))
    np.testing.assert_array_equal(port.extract_patch(backend, out[3]),
                                  ref.extract_patch(backend, want[3]))
    assert port.get_metadata(backend, "x") == ref.get_metadata(backend, "x")


def test_process_slide_matches_jax():
    kw = dict(patch_size=32, max_patches=30, tissue_threshold=0.3, stain_normalize=False)
    out = SlideProcessor(**kw, device="cpu").process_slide(
        synthetic.synthetic_slide(512, 512, num_levels=3, seed=5)[0], slide_id="s")
    ref = JaxProcessor(**kw).process_slide(
        jsyn.synthetic_slide(512, 512, num_levels=3, seed=5)[0], slide_id="s")
    assert out.num_patches == ref.num_patches == 30
    assert [vars(p) for p in out.patch_info] == [vars(p) for p in ref.patch_info]
    np.testing.assert_array_equal(out.patches, ref.patches)
    np.testing.assert_array_equal(out.tissue_mask, ref.tissue_mask)
    assert out.metadata == ref.metadata


def test_decode_workers_see_no_card_and_decode_like_the_process(tmp_path):
    """A spawned decode worker hides every CUDA device before it does
    anything, and decodes what the process itself decodes."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    path = tiff.write_tiled_tiff(tmp_path / "s.tif", _pyramid(), compression="deflate",
                                 description="Aperio X|AppMag = 20")
    slide = slide_io.open_slide(path)
    proc = SlideProcessor(patch_size=64, stain_normalize=False, device="cpu")
    infos = [PatchInfo(x, y, 0, 20.0, 64, 1.0) for x in range(0, 512, 64) for y in (0, 128)]
    with ProcessPoolExecutor(max_workers=2, mp_context=mp.get_context("spawn"),
                             initializer=_decode_worker_init) as pool:
        env = pool.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result(timeout=120)
        parallel = proc.extract_patch_batch_parallel(slide, infos, pool, workers=2)
    assert env == ""
    np.testing.assert_array_equal(parallel, proc.extract_patch_batch(slide, infos))
    np.testing.assert_array_equal(
        _decode_patches_worker(str(path), 64, [(p.x, p.y, 0, 20.0, 64) for p in infos[:3]]),
        parallel[:3])
    slide.close()
