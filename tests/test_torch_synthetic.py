"""The port's synthetic slide writers and band renderer
(``dgdm_histopath_torch/preprocessing/synthetic.py``) against the JAX
package's, on the CPU.

The host paths (``device="numpy"``) write the JAX package's pixels bit for
bit. The band renderer's core, fed the random fields the JAX renderer draws
(``fold_in``, ``split``, ``uniform``, ``normal`` as ``_device_band_renderer``
draws them), equals the jitted JAX renderer within one uint8 step at every
level, on at most 0.1% of the pixels (f32 sums in other orders and XLA's
``cos`` / ``sin``; the share measured is printed by the test's failure
message), and its tissue field within 1e-5.
"""

import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.preprocessing import synthetic as jsyn
from dgdm_histopath_torch.preprocessing import slide_io, synthetic


def h5_levels(path):
    import h5py
    with h5py.File(path) as f:
        return ({k: v for k, v in f.attrs.items()},
                [(f[k][:], f[k].chunks, f[k].compression, f[k].compression_opts)
                 for k in sorted(f) if k.startswith("level_")])


@pytest.mark.parametrize("compression", ["gzip", "lzf"])
def test_write_synthetic_slide_hdf5_numpy_is_jax_bit_for_bit(tmp_path, compression):
    kw = dict(width=640, height=384, num_levels=3, tile=256, seed=4, num_blobs=6,
              nuclei_density=2e-3, compression=compression, chunk_px=128, device="numpy")
    ours = h5_levels(synthetic.write_synthetic_slide_hdf5(tmp_path / "p.h5", **kw))
    theirs = h5_levels(jsyn.write_synthetic_slide_hdf5(tmp_path / "j.h5", **kw))
    assert ours[0] == theirs[0]
    assert len(ours[1]) == len(theirs[1]) == 3
    for (a, *fmt_a), (b, *fmt_b) in zip(ours[1], theirs[1]):
        assert fmt_a == fmt_b
        np.testing.assert_array_equal(a, b)
    assert not (tmp_path / "p.h5.tmp").exists()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_hard_slide_params_match_jax(seed):
    assert synthetic.HARD_TASK_DEFAULTS == jsyn.HARD_TASK_DEFAULTS
    assert synthetic.HARD_MULTICLASS_BANDS == jsyn.HARD_MULTICLASS_BANDS
    for tumor in (True, False):
        kw = dict(tumor=tumor, size=512, seed=seed + 10)
        extra = {"noise_sigma": (1.0, 2.0)} if seed == 3 else {}
        ours = synthetic.sample_hard_slide_params(np.random.RandomState(seed), **kw, **extra)
        theirs = jsyn.sample_hard_slide_params(np.random.RandomState(seed), **kw, **extra)
        assert ours == theirs


def jax_band(width, band, levels, density, seed, bi, ty, blobs, coarse):
    """The JAX renderer's outputs, its random fields as it draws them, and
    its tissue field (the renderer's blob scan)."""
    import jax
    import jax.numpy as jnp
    key = jax.random.fold_in(jax.random.PRNGKey(seed), bi)
    outs = jsyn._device_band_renderer(width, band, levels, density)(
        jnp.asarray(blobs), jnp.asarray(coarse), jnp.float32(ty), key)
    k_nuc, k_noise = jax.random.split(key)
    uniform = jax.random.uniform(k_nuc, (band, width))
    normal = jax.random.normal(k_noise, (band, width, 3))

    @jax.jit
    def tissue(blobs, ty):
        xx = jnp.arange(width, dtype=jnp.float32)[None, :]
        yy = (jnp.arange(band, dtype=jnp.float32) + ty)[:, None]

        def step(t, b):
            c, s = jnp.cos(b[4]), jnp.sin(b[4])
            dx = (xx - b[0]) * c + (yy - b[1]) * s
            dy = -(xx - b[0]) * s + (yy - b[1]) * c
            d = (dx / b[2]) ** 2 + (dy / b[3]) ** 2
            return jnp.maximum(t, jnp.clip(1.5 - d, 0.0, 1.0)), None
        return jax.lax.scan(step, jnp.zeros((band, width), jnp.float32), blobs)[0]

    return ([np.array(o) for o in outs], np.array(uniform), np.array(normal),
            np.array(tissue(jnp.asarray(blobs), jnp.float32(ty))))


@pytest.mark.parametrize("bi", [0, 2])
def test_render_band_fed_jaxs_draws_matches_the_jax_renderer(bi):
    width, band, levels, density, seed = 384, 64, 3, 0.02, 5
    rs = np.random.RandomState(seed)
    blobs = np.asarray(synthetic._make_blobs(rs, width, 4 * band, 6), np.float32)
    coarse = rs.rand(4 * band // 32 + 2, width // 32 + 2).astype(np.float32)
    ty = bi * band
    want, uniform, normal, tissue = jax_band(width, band, levels, density, seed, bi, ty,
                                             blobs, coarse)
    t_blobs = torch.from_numpy(blobs)
    got = synthetic.render_band(t_blobs, torch.from_numpy(coarse), ty, torch.from_numpy(uniform),
                                torch.from_numpy(normal), density, levels)
    np.testing.assert_allclose(synthetic.band_tissue(t_blobs, ty, band, width).numpy(), tissue,
                               atol=1e-5, rtol=0)
    assert tissue.max() > 0.5 and 0 < (uniform < density).mean() < 0.05
    for lvl, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (band >> lvl, width >> lvl, 3) and a.dtype == torch.uint8
        diff = np.abs(a.numpy().astype(int) - b.astype(int))
        share = float((diff > 0).mean())
        assert diff.max() <= 1 and share <= 1e-3, (lvl, int(diff.max()), share)


def test_band_renderer_on_the_cpu_writes_slides_that_read_back(tmp_path):
    """``device="cpu"``: the torch band renderer writes both formats; the
    draws are the seeded generator's (the same bytes twice), band 1 of
    level 0 equals :func:`render_band` of that band's draws."""
    kw = dict(width=256, height=256, num_levels=3, seed=2, num_blobs=4, nuclei_density=5e-3,
              device="cpu")
    h5 = synthetic.write_synthetic_slide_hdf5(tmp_path / "a.h5", tile=128, chunk_px=64, **kw)
    again = synthetic.write_synthetic_slide_hdf5(tmp_path / "b.h5", tile=128, chunk_px=64, **kw)
    for (a, *_), (b, *_) in zip(h5_levels(h5)[1], h5_levels(again)[1]):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(2)
    blobs = torch.tensor(synthetic._make_blobs(rs, 256, 256, 4), dtype=torch.float32)
    coarse = torch.from_numpy(rs.rand(256 // 32 + 2, 256 // 32 + 2).astype(np.float32))
    u, n = synthetic.draw_band_fields(128, 256, 2, 1, "cpu")
    band1 = synthetic.render_band(blobs, coarse, 128, u, n, 5e-3, 3)
    slide = slide_io.open_slide(h5)
    np.testing.assert_array_equal(slide.read_region((0, 128), 0, (256, 128)), band1[0].numpy())
    np.testing.assert_array_equal(slide.read_region((0, 128), 1, (128, 64)), band1[1].numpy())
    slide.close()
    timings = {}
    tif = synthetic.write_synthetic_slide_tiff(tmp_path / "c.tif", band=128, tiff_tile=64,
                                               compression="deflate", timings=timings, **kw)
    t = slide_io.open_slide(tif)
    assert t.level_dimensions == [(256, 256), (128, 128), (64, 64)]
    np.testing.assert_array_equal(t.read_region((0, 128), 0, (256, 128)), band1[0].numpy())
    t.close()
    assert timings["bands"] == 2 and timings["render_s"] > 0 and timings["encode_s"] > 0


@pytest.mark.parametrize("writer", ["hdf5", "tiff"])
def test_device_is_the_card_by_default_and_shapes_must_split(tmp_path, writer):
    write = (synthetic.write_synthetic_slide_hdf5 if writer == "hdf5"
             else synthetic.write_synthetic_slide_tiff)
    band = dict(tile=128) if writer == "hdf5" else dict(band=128, tiff_tile=64)
    for device in (None, "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            write(tmp_path / "x", width=256, height=256, num_levels=3, device=device, **band)
    bad = dict(tile=96) if writer == "hdf5" else dict(band=96, tiff_tile=64)
    with pytest.raises(ValueError, match="2\\^\\(levels-1\\) \\(4\\)"):
        write(tmp_path / "y", width=256, height=256, num_levels=3, device="cpu", **bad)
    assert not list(tmp_path.iterdir())


def test_write_synthetic_tiff_is_the_jax_file(tmp_path):
    pytest.importorskip("PIL")
    kw = dict(width=256, height=192, num_levels=3, seed=6, num_blobs=3)
    ours = synthetic.write_synthetic_tiff(tmp_path / "p.tif", **kw)
    theirs = jsyn.write_synthetic_tiff(tmp_path / "j.tif", **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    slide = slide_io.open_slide(ours)
    assert slide.level_dimensions == [(256, 192), (128, 96), (64, 48)]
    slide.close()
