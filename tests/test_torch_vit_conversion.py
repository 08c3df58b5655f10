"""The port's timm DINOv2 converter (``dgdm_histopath_torch/scripts/
convert_timm_vit.py``) against the repository's JAX-side converter
(``scripts/convert_timm_vit.py``), on the CPU.

Tolerances: converted leaves and the bicubic position-embedding resize
within 1e-6 of JAX's (f32; the resize's weights are formed as
``jax.image.resize`` forms them, the two sums differ in order only: 1.2e-7
measured on the resize, 4.8e-8 on the bundles' leaves); features of the two
packages' extractors on each other's bundle within 1e-4 (f32 ViTs, 6.0e-7
measured).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from scripts import convert_timm_vit as jconv  # noqa: E402

from dgdm_histopath_tpu.models import vit as jvit  # noqa: E402
from dgdm_histopath_torch.models import vit  # noqa: E402
from dgdm_histopath_torch.scripts import convert_timm_vit as conv  # noqa: E402

DIM, DEPTH, HEADS, PATCH = 32, 2, 4, 8      # a tiny ViT of the full structure
GRIDS = [(37, 16), (16, 16), (16, 37)]      # DINOv2's 518 px grid -> 224 px, same, up


def timm_state_dict(seed=0, layer_scale=True, grid=4, dim=DIM, depth=DEPTH, patch=PATCH):
    """A seeded random state dict in timm's ViT layout."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.05  # noqa: E731
    sd = {"cls_token": r(1, 1, dim), "pos_embed": r(1, grid * grid + 1, dim),
          "patch_embed.proj.weight": r(dim, 3, patch, patch), "patch_embed.proj.bias": r(dim),
          "norm.weight": 1.0 + r(dim), "norm.bias": r(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1.0 + r(dim), p + "norm1.bias": r(dim),
                   p + "attn.qkv.weight": r(3 * dim, dim), p + "attn.qkv.bias": r(3 * dim),
                   p + "attn.proj.weight": r(dim, dim), p + "attn.proj.bias": r(dim),
                   p + "norm2.weight": 1.0 + r(dim), p + "norm2.bias": r(dim),
                   p + "mlp.fc1.weight": r(4 * dim, dim), p + "mlp.fc1.bias": r(4 * dim),
                   p + "mlp.fc2.weight": r(dim, 4 * dim), p + "mlp.fc2.bias": r(dim)})
        if layer_scale:
            sd[p + "ls1.gamma"] = 0.1 + r(dim).abs()
            sd[p + "ls2.gamma"] = 0.1 + r(dim).abs()
    return sd


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture
def tiny_arch():
    """A tiny ViT registered under one name in both packages' arch tables."""
    kw = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, patch_size=PATCH, layer_scale=True)
    jvit._ARCHS["_tiny_b8"] = (kw, DIM)
    vit._ARCHS["_tiny_b8"] = (kw, DIM)
    yield "_tiny_b8"
    jvit._ARCHS.pop("_tiny_b8", None)
    vit._ARCHS.pop("_tiny_b8", None)


@pytest.mark.parametrize("layer_scale", [True, False], ids=["ls", "no_ls"])
@pytest.mark.parametrize("grids", GRIDS, ids=[f"{a}to{b}" for a, b in GRIDS])
def test_convert_state_dict_matches_jax(layer_scale, grids):
    g_old, g_new = grids
    sd = {k: v.numpy() for k, v in timm_state_dict(1, layer_scale, g_old).items()}
    ours = flat(conv.convert_state_dict(sd, DEPTH, HEADS, g_new * g_new + 1))
    ref = flat(jconv.convert_state_dict(sd, DEPTH, HEADS, g_new * g_new + 1))
    assert sorted(ours) == sorted(ref)
    assert ours["params/pos_embed"].shape == (1, g_new * g_new + 1, DIM)
    for key in ref:
        assert ours[key].dtype == np.float32 and ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("grids", GRIDS + [(5, 3), (3, 7)],
                         ids=[f"{a}to{b}" for a, b in GRIDS + [(5, 3), (3, 7)]])
def test_interpolate_pos_embed_matches_jax_bicubic(grids):
    g_old, g_new = grids
    pos = (np.random.RandomState(g_old * 100 + g_new).randn(1, g_old * g_old + 1, 768)
           * 0.05).astype(np.float32)
    ours = conv.interpolate_pos_embed(pos, g_new * g_new + 1)
    ref = np.asarray(jconv.interpolate_pos_embed(pos, g_new * g_new + 1))
    np.testing.assert_array_equal(ours[:, 0], pos[:, 0])          # the CLS position
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    if g_old != g_new:   # not torch's bicubic (a = -0.75, no antialias)
        grid = torch.from_numpy(pos[:, 1:].reshape(1, g_old, g_old, -1)).permute(0, 3, 1, 2)
        other = torch.nn.functional.interpolate(grid, (g_new, g_new), mode="bicubic",
                                                align_corners=False)
        other = other.permute(0, 2, 3, 1).reshape(1, -1, pos.shape[-1]).numpy()
        assert np.abs(other - ref[:, 1:]).max() > 1e-4


def test_non_square_grid_raises():
    with pytest.raises(ValueError, match="non-square"):
        conv.interpolate_pos_embed(np.zeros((1, 11, 4), np.float32), 17)


@pytest.mark.parametrize("layer_scale", [True, False], ids=["ls", "no_ls"])
def test_both_bundles_load_into_both_extractors(tmp_path, tiny_arch, layer_scale):
    """The port's CLI and JAX's CLI write the same bundle from one .pth; each
    package's extractor loads either bundle; the features agree."""
    size = 5 * PATCH
    src = tmp_path / "sd.pth"
    sd = timm_state_dict(2, layer_scale, grid=7)      # a 7 x 7 grid resized to 5 x 5
    if not layer_scale:
        vit._ARCHS[tiny_arch][0]["layer_scale"] = False
    torch.save(sd, src)
    ours, ref = tmp_path / "port.npz", tmp_path / "jax.npz"
    argv = ["--arch", tiny_arch, "--image-size", str(size)]
    assert conv.main([str(src), str(ours), *argv, "--cpu"]) == 0
    assert jconv.main([str(src), str(ref), *argv]) == 0
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        meta_a, meta_b = json.loads(str(a["__meta__"])), json.loads(str(b["__meta__"]))
        assert meta_a["model_config"] == meta_b["model_config"]
        assert meta_a["extra"]["feature_dim"] == meta_b["extra"]["feature_dim"] == DIM
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
    patches = np.random.RandomState(3).randint(0, 255, (4, size, size, 3), np.uint8)
    feats = {}
    for name, bundle in (("port", ours), ("jax", ref)):
        pe = vit.PatchFeatureExtractor(arch=tiny_arch, image_size=size, device="cpu",
                                       dtype="float32")
        pe.load_npz_weights(str(bundle))
        je = jvit.PatchFeatureExtractor(arch=tiny_arch, image_size=size)
        je.module = jvit.VisionTransformer(**jvit._ARCHS[tiny_arch][0], dtype=jnp.float32)
        je.load_npz_weights(str(bundle))
        with jax.default_matmul_precision("float32"):
            feats[name] = (pe.extract(patches), np.asarray(je.extract(patches)))
    for got in (feats["port"][0], feats["jax"][0], feats["port"][1]):
        np.testing.assert_allclose(got, feats["jax"][1], atol=1e-4, rtol=0)


def test_converted_vit_matches_the_timm_forward(tiny_arch):
    """The converted weights in the port's ViT give timm's features."""
    sd = {k: v.numpy() for k, v in timm_state_dict(4, True, grid=4).items()}
    params = conv.convert_state_dict(sd, DEPTH, HEADS, 17)
    assert conv.check_conversion(sd, params, tiny_arch, 4 * PATCH, "cpu") < 1e-5


def test_structure_mismatch_fails_the_conversion(tmp_path, tiny_arch, capsys):
    sd = timm_state_dict(5, True, grid=4)
    sd = {k: v for k, v in sd.items() if not k.startswith("blocks.1.ls")}
    torch.save(sd, tmp_path / "bad.pth")
    rc = conv.main([str(tmp_path / "bad.pth"), str(tmp_path / "out.npz"), "--arch",
                    tiny_arch, "--image-size", str(4 * PATCH), "--cpu"])
    assert rc == 1 and not (tmp_path / "out.npz").exists()
    assert "structure mismatch" in capsys.readouterr().err


def test_npz_input_and_prefixes(tmp_path, tiny_arch):
    """An .npz of the tensors converts like the .pth; ``module.`` /
    ``backbone.`` prefixes and a ``state_dict`` wrapper are stripped."""
    sd = timm_state_dict(6, True, grid=4)
    np.savez(tmp_path / "sd.npz", **{k: v.numpy() for k, v in sd.items()})
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, tmp_path / "w.pth")
    a = conv.load_torch_state_dict(tmp_path / "sd.npz")
    b = conv.load_torch_state_dict(tmp_path / "w.pth")
    assert sorted(a) == sorted(b) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(a[k], b[k])
