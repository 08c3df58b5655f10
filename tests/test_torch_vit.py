"""The port's patch featurizer (``dgdm_histopath_torch/models/vit.py``)
against the JAX package's ``models/vit.py``, on the CPU, at small widths,
with the flax parameters carried over by ``convert.encoder_params_from_flax``.

Tolerances: f32 encoders within 1e-5 (2.4e-7 measured); bf16 within 2% of
the largest feature (one bf16 ulp is 0.4-0.8%; the ViT measured equal, the
conv encoder 0.7%); the stain statistics within 1e-5 of their scale; the
resize within 2e-4 on the 0-255 scale (6.1e-5 measured: the reference sums
each output pixel in another order); the fused forward within 1e-4 of the
largest feature (its Macenko step differs by up to 5e-3 on the 0-255 scale,
see ``tests/test_torch_stain.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.models import vit as jvit
from dgdm_histopath_tpu.preprocessing.synthetic import generate_tissue_image
from dgdm_histopath_tpu.training.checkpoint import save_model_bundle
from dgdm_histopath_torch.convert import encoder_params_from_flax, load_state
from dgdm_histopath_torch.models import vit

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TINY = dict(embed_dim=64, depth=2, num_heads=4)


def _images(n=3, size=64, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _pair(jax_module, port_module, x, seed=0):
    params = jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    load_state(port_module, encoder_params_from_flax(params))
    return params


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geometry", [dict(patch_size=16), dict(patch_size=14, layer_scale=True)])
def test_vision_transformer_matches_jax(dtype, geometry):
    jdt, tdt, tol = DTYPES[dtype]
    size = 4 * geometry["patch_size"]
    x = _images(size=size)
    jm = jvit.VisionTransformer(**TINY, **geometry, dtype=jdt)
    tm = vit.VisionTransformer(**TINY, **geometry, image_size=size, dtype=tdt)
    params = _pair(jm, tm, x)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 64) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("size", [64, 50])      # 50: "SAME" pads one side, then both
def test_simple_conv_encoder_matches_jax(dtype, size):
    jdt, tdt, tol = DTYPES[dtype]
    x = _images(size=size)
    jm, tm = jvit.SimpleConvEncoder(embed_dim=32, dtype=jdt), vit.SimpleConvEncoder(32, tdt)
    params = _pair(jm, tm, x, seed=1)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _tissue_patches(n=6, size=64, seed=3):
    img, _ = generate_tissue_image(512, 512, seed=seed)
    return np.stack([img[(i // 3) * 128:(i // 3) * 128 + size, (i % 3) * 128:(i % 3) * 128 + size]
                     for i in range(n)])


def test_stain_stat_features_match_jax():
    p = _tissue_patches().astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jvit.stain_stat_features(jnp.asarray(p)))
    out = vit.stain_stat_features(torch.from_numpy(p)).numpy()
    assert out.shape == (6, vit.STAIN_STATS_DIM)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("sizes", [(64, 56), (256, 224), (40, 48)])
def test_resize_matches_jax_image_resize(sizes):
    s, o = sizes
    x = np.random.RandomState(0).randint(0, 256, (2, s, s, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, o, o, 3), method="bilinear"))
    out = vit.resize_bilinear(torch.from_numpy(x), o).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    u8 = x.astype(np.uint8)
    np.testing.assert_array_equal(vit.host_resize_u8(u8, o), jvit.host_resize_u8(u8, o))


def _extractors(**kw):
    """The JAX and the port extractor (stain normalization on the device,
    64 px resized to 56) with a tiny f32 ViT in place of ViT-B/16, the same
    weights on both sides."""
    jext = jvit.PatchFeatureExtractor(arch="stats", image_size=56, **kw)
    text = vit.PatchFeatureExtractor(arch="stats", image_size=56, device="cpu", **kw)
    jm = jvit.VisionTransformer(**TINY, patch_size=8, dtype=jnp.float32)
    tm = vit.VisionTransformer(**TINY, patch_size=8, image_size=56, dtype=torch.float32)
    params = _pair(jm, tm, np.zeros((1, 56, 56, 3), np.float32))
    jext.module, jext.params, jext.append_stain_stats = jm, params, True
    text.module, text.append_stain_stats = tm.eval(), True
    jext.feature_dim = text.feature_dim = 64 + vit.STAIN_STATS_DIM
    return jext, text, params


def test_fused_forward_matches_jax():
    jext, text, params = _extractors(stain_normalize_on_device=True)
    p = _tissue_patches()
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.jit(jext._fused_forward)(params, jnp.asarray(p)))
    with torch.inference_mode():
        out = text.fused_forward(torch.from_numpy(p)).numpy()
    assert out.shape == (6, 64 + vit.STAIN_STATS_DIM)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_extract_batches_and_fetches_once_and_warns_once():
    _, text, _ = _extractors(batch_size=4)
    text.weights_loaded = False
    p = _tissue_patches(n=6)
    with pytest.warns(UserWarning, match="random weights"):
        feats = text.extract(p)
    with torch.inference_mode():
        whole = text.fused_forward(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(feats, whole, atol=1e-5, rtol=0)
    assert text.extract(p[:0]).shape == (0, text.feature_dim)


@pytest.mark.parametrize("arch,dim", [("stats", 14), ("simple_cnn+stats", 526)])
def test_archs_and_feature_dims(arch, dim):
    ext = vit.PatchFeatureExtractor(arch=arch, device="cpu", image_size=32)
    ref = jvit.PatchFeatureExtractor(arch=arch, image_size=32)
    assert ext.feature_dim == ref.feature_dim == dim and ext.arch == ref.arch
    out = ext.extract(_tissue_patches(n=2, size=32))
    assert out.shape == (2, dim) and np.isfinite(out).all()
    # int8 (item 13) needs a ViT arch, in both packages
    with pytest.raises(ValueError, match="requires a ViT arch"):
        vit.PatchFeatureExtractor(arch=arch, device="cpu", quant="int8")
    with pytest.raises(ValueError, match="requires a ViT arch"):
        jvit.PatchFeatureExtractor(arch=arch, quant="int8")


def test_load_npz_weights_reads_a_jax_bundle(tmp_path):
    jm = jvit.SimpleConvEncoder()
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    path = save_model_bundle(tmp_path / "cnn.npz", params, {})
    ext = vit.PatchFeatureExtractor(arch="simple_cnn", device="cpu", image_size=32)
    assert not ext.weights_loaded
    ext.load_npz_weights(str(path))
    assert ext.weights_loaded
    want = encoder_params_from_flax(params)
    for key, value in ext.module.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)


def test_vit_flops_count_the_products():
    """ViT-B/16 at 224: ~35 GFLOP an image; the tiny config counted by hand."""
    assert 34.5e9 < vit.vit_flops() < 35.5e9
    t, d = 17, 64          # 64 px / 16 -> 16 patches + CLS
    embed = 2 * 16 * 768 * d
    block = 2 * t * d * d * 12 + 4 * t * t * d
    assert vit.vit_flops(64, 16, d, 2) == embed + 2 * block
