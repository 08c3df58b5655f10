"""The port's stain normalization and tissue detection
(``dgdm_histopath_torch/preprocessing/{stain_normalization,tissue_detection}.py``)
against the JAX package's, on the CPU, on patches of the synthetic H&E
generator.

Tolerances:

* Macenko stain matrices within 1e-5. The reference sums the OD covariance of
  its (at most 4096) sampled pixels in f32, one pixel after the other; the
  port sums it in f64. That difference alone moves the stain vectors by up
  to ~6e-6 (measured on these patches).
* Macenko-normalized pixels within 5e-3 on the 0-255 scale: the stain
  matrices' differences, through the concentrations (up to ~3) and
  ``255 exp(-od)``, move bright pixels by up to ~3.6e-3 (measured; 1.4e-5 of
  full scale).
* Reinhard within 3e-3 on the 0-255 scale (log10 / pow rounding; 1.3e-3
  measured).
* The tissue mask: the Otsu threshold equal, at most 0.05% of the pixels
  differing (0 measured on these thumbnails); the area filter and the
  k-means detector equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.preprocessing import stain_normalization as jst
from dgdm_histopath_tpu.preprocessing import tissue_detection as jtd
from dgdm_histopath_tpu.preprocessing.synthetic import generate_tissue_image, synthetic_slide
from dgdm_histopath_torch.preprocessing import stain_normalization as st
from dgdm_histopath_torch.preprocessing import tissue_detection as td


def patches(size, seed=3):
    img, _ = generate_tissue_image(1024, 1024, seed=seed)
    return np.stack([img[y:y + size, x:x + size] for y in range(0, 1024 - size + 1, 256)
                     for x in range(0, 1024 - size + 1, 256)])


def sample(p):
    """The estimator's pixel sample of each patch (stats_pixels = 4096)."""
    flat = p.reshape(len(p), -1, 3)
    stride = max(1, flat.shape[1] // 4096)
    return np.ascontiguousarray(flat[:, ::stride][:, :4096])


def jax_stain_matrices(p):
    with jax.default_matmul_precision("float32"):
        return np.array(jax.jit(jax.vmap(jst.estimate_stain_matrix))(jnp.asarray(sample(p))))


@pytest.mark.parametrize("size,seed", [(64, 3), (128, 4), (256, 3)])
def test_macenko_batch_matches_jax(size, seed):
    p = patches(size, seed)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jst.macenko_normalize_batch(
            jnp.asarray(p), jnp.asarray(jst.DEFAULT_STAIN_MATRIX),
            jnp.asarray(jst.DEFAULT_MAX_CONCENTRATIONS)))
    out = st.macenko_normalize_batch(torch.from_numpy(p),
                                     torch.from_numpy(st.DEFAULT_STAIN_MATRIX),
                                     torch.from_numpy(st.DEFAULT_MAX_CONCENTRATIONS)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=0)
    tsm = st.estimate_stain_matrix(torch.from_numpy(sample(p))).numpy()
    np.testing.assert_allclose(tsm, jax_stain_matrices(p), atol=1e-5, rtol=0)


@pytest.mark.parametrize("flip", [(1, 1), (-1, 1), (1, -1), (-1, -1)])
def test_stain_matrix_does_not_depend_on_eigenvector_signs(flip, monkeypatch):
    """LAPACK and cuSOLVER may return either sign for each eigenvector: each
    of the four sign choices of the top two gives the reference's matrix."""
    p = patches(256, seed=3)
    eigh = torch.linalg.eigh

    def flipped(a):
        w, v = eigh(a)
        sign = torch.tensor([1.0, *flip], dtype=v.dtype)
        return w, v * sign
    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    tsm = st.estimate_stain_matrix(torch.from_numpy(sample(p))).numpy()
    np.testing.assert_allclose(tsm, jax_stain_matrices(p), atol=1e-5, rtol=0)


def test_stain_concentrations_match_jax():
    p = sample(patches(128, seed=4))[:4]
    stains = jax_stain_matrices(patches(128, seed=4))[:4]
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.vmap(jst.stain_concentrations)(jnp.asarray(p), jnp.asarray(stains)))
    out = st.stain_concentrations(torch.from_numpy(p), torch.from_numpy(stains)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def test_reinhard_matches_jax():
    p = patches(128, seed=3)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jst.reinhard_normalize_batch(
            jnp.asarray(p), jnp.asarray(jst.DEFAULT_LAB_MEAN), jnp.asarray(jst.DEFAULT_LAB_STD)))
    out = st.reinhard_normalize_batch(torch.from_numpy(p), torch.from_numpy(st.DEFAULT_LAB_MEAN),
                                      torch.from_numpy(st.DEFAULT_LAB_STD)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-3, rtol=0)


@pytest.mark.parametrize("method", ["macenko", "reinhard"])
def test_stain_normalizer_matches_jax(method):
    """uint8 in, uint8 out, a template fitted first: the pixels round to the
    same integer but where the f32 result lies within the tolerances above
    of a .5, which moves them by one: with errors up to 5e-3, at most ~1% of
    them (0.24% measured for Macenko)."""
    p = patches(128, seed=4)
    template = patches(256, seed=5)[0]
    with jax.default_matmul_precision("float32"):
        ref = jst.StainNormalizer(method).fit_to_template(template).normalize(p)
    port = st.StainNormalizer(method, device="cpu").fit_to_template(template)
    out = port.normalize(p)
    assert out.dtype == np.uint8 and out.shape == p.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    assert port.normalize(p[0]).shape == p[0].shape


def thumbnails():
    return [synthetic_slide(1024, 1024, num_levels=3, seed=s)[0].get_thumbnail(256)
            for s in range(4)]


def test_compute_tissue_mask_matches_jax():
    for thumb in thumbnails():
        ref = np.asarray(jtd.compute_tissue_mask(jnp.asarray(thumb)))
        out = td.compute_tissue_mask(torch.from_numpy(thumb)).numpy()
        assert (out != ref).mean() <= 5e-4
        gray = jtd.rgb_to_gray(jtd.gaussian_blur(jnp.asarray(thumb, jnp.float32)))
        tgray = td.rgb_to_gray(td.gaussian_blur(torch.from_numpy(thumb).float()))
        assert float(jtd.otsu_threshold(gray)) == float(td.otsu_threshold(tgray))
        np.testing.assert_allclose(tgray.numpy(), np.asarray(gray), atol=1e-3, rtol=0)


def test_gaussian_blur_and_morphology_match_jax():
    rs = np.random.RandomState(0)
    img = rs.rand(40, 50, 3).astype(np.float32) * 255
    np.testing.assert_allclose(td.gaussian_blur(torch.from_numpy(img), 1.5).numpy(),
                               np.asarray(jtd.gaussian_blur(jnp.asarray(img), 1.5)),
                               atol=1e-4, rtol=0)
    mask = rs.rand(40, 50) > 0.6
    for op in ("dilate", "erode"):
        np.testing.assert_array_equal(
            td._binary_morph(torch.from_numpy(mask), 5, op).numpy(),
            np.asarray(jtd._binary_morph(jnp.asarray(mask), 5, op)))


@pytest.mark.parametrize("method", ["composite", "kmeans"])
def test_tissue_detector_matches_jax(method):
    for thumb in thumbnails()[:2]:
        ref = jtd.TissueDetector(method=method).detect_tissue(thumb)
        out = td.TissueDetector(method=method, device="cpu").detect_tissue(thumb)
        assert (out != ref).mean() <= 5e-4
        jstats = jtd.TissueDetector().get_tissue_stats(ref)
        tstats = td.TissueDetector(device="cpu").get_tissue_stats(ref)
        assert tstats == td.TissueStats(**vars(jstats))


def test_connected_components_filter_matches_jax():
    mask = np.random.RandomState(1).rand(64, 64) > 0.55
    for area in (0, 1, 3, 10):
        np.testing.assert_array_equal(td.connected_components_filter(mask, area),
                                      jtd.connected_components_filter(mask, area))
