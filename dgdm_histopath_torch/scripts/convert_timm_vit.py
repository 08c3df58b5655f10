"""Convert a timm DINOv2 ViT state dict into a weight bundle for the port's
``PatchFeatureExtractor`` (and the JAX package's: the bundle is the same).

The reference featurizes patches with timm's pretrained
``vit_base_patch14_dinov2.lvd142m``. Conversion is file based: give it a
``torch.save`` state dict (.pth / .pt / .bin, read with ``weights_only=True``)
or an .npz of the same tensors; it writes the ``named_paths_v2`` npz bundle
(``p:params/...`` arrays and a ``__meta__`` JSON) that
``PatchFeatureExtractor.load_npz_weights`` reads. Torch and numpy only.

Layout map (timm ``VisionTransformer`` -> the flax-named tree both packages
read):

  cls_token                         -> cls_token                  [1, 1, D]
  pos_embed                         -> pos_embed (grid resized bicubically
                                       when the image size differs)
  patch_embed.proj.weight [D,3,P,P] -> patch_embed/kernel [P,P,3,D]
  patch_embed.proj.bias             -> patch_embed/bias
  blocks.i.norm1.{weight,bias}      -> block{i}/norm1/{scale,bias}
  blocks.i.attn.qkv.weight [3D,D]   -> block{i}/attn/{query,key,value}/kernel
                                       [D, H, D/H]
  blocks.i.attn.qkv.bias [3D]       -> .../{query,key,value}/bias [H, D/H]
  blocks.i.attn.proj.weight [D,D]   -> block{i}/attn/out/kernel [H, D/H, D]
  blocks.i.attn.proj.bias           -> block{i}/attn/out/bias [D]
  blocks.i.ls{1,2}.gamma            -> block{i}/ls{1,2}_gamma (LayerScale)
  blocks.i.mlp.fc{1,2}.{weight,bias} -> block{i}/mlp{1,2}/{kernel,bias}
  norm.{weight,bias}                -> norm/{scale,bias}

The converted weights are loaded into the port's ``VisionTransformer`` of
``--arch`` (a missing, extra or misshapen tensor fails the conversion), and
one seeded image goes through it and through :func:`timm_vit_forward`, a
forward of the timm layout straight from the state dict; they must agree.
That check runs on the card unless ``--cpu`` is given.

    python -m dgdm_histopath_torch.scripts.convert_timm_vit dinov2_b14.pth \\
        dinov2_b14.npz --arch dinov2_b14 --image-size 224
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# the largest |difference| between the converted model's f32 features and
# timm_vit_forward's that the conversion's check accepts (LayerNormed
# outputs of order 1; the two forwards differ in summation order only)
CHECK_ATOL = 1e-3


def load_torch_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """Tensors of a torch checkpoint file or an npz, as numpy arrays."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k.removeprefix("module.").removeprefix("backbone."): v.detach().cpu().numpy()
            for k, v in sd.items()}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, in f32."""
    f = np.float32
    x = np.abs(x)
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(f)


@functools.lru_cache(maxsize=8)
def bicubic_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """Resize weights [in_size, out_size] of ``jax.image.resize(...,
    "bicubic")``: Keys' kernel on half-pixel centres, widened by the scale
    when downsampling (antialiased), each column normalized, in f32 as it
    forms them. ``torch.nn.functional.interpolate(mode="bicubic")`` is
    another function (a = -0.75, no antialias)."""
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f(1.0))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000 * np.finfo(f).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def interpolate_pos_embed(pos: np.ndarray, target_tokens: int) -> np.ndarray:
    """Resize the grid part of a [1, 1 + G*G, D] position embedding to a new
    square grid, bicubically (timm does the same when the input resolution
    changes); the CLS position is kept."""
    if pos.shape[1] == target_tokens:
        return pos
    cls_pos, grid_pos = pos[:, :1], pos[:, 1:]
    g_old = int(round(np.sqrt(grid_pos.shape[1])))
    g_new = int(round(np.sqrt(target_tokens - 1)))
    if g_old * g_old != grid_pos.shape[1] or g_new * g_new != target_tokens - 1:
        raise ValueError(f"non-square pos grids: {grid_pos.shape[1]} -> "
                         f"{target_tokens - 1}")
    d = grid_pos.shape[-1]
    grid = np.asarray(grid_pos, np.float32).reshape(g_old, g_old, d).astype(np.float64)
    w = bicubic_weight_mat(g_old, g_new).astype(np.float64)
    resized = np.einsum("ijd,ik,jl->kld", grid, w, w).astype(np.float32)
    return np.concatenate([cls_pos, resized.reshape(1, g_new * g_new, d)], axis=1)


def convert_state_dict(sd: Dict[str, np.ndarray], depth: int, num_heads: int,
                       target_tokens: Optional[int] = None) -> Dict:
    """timm torch layout -> the flax-named ``VisionTransformer`` tree
    ``{"params": {...}}`` of f32 numpy arrays."""
    d = int(sd["cls_token"].shape[-1])
    dh = d // num_heads
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    pos = f32(sd["pos_embed"])
    if target_tokens is not None:
        pos = interpolate_pos_embed(pos, target_tokens)
    params: Dict = {
        "cls_token": f32(sd["cls_token"]),
        "pos_embed": pos,
        "patch_embed": {
            "kernel": f32(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": f32(sd["patch_embed.proj.bias"]),
        },
        "norm": {"scale": f32(sd["norm.weight"]), "bias": f32(sd["norm.bias"])},
    }
    mk = lambda w: w.T.reshape(d, num_heads, dh)      # noqa: E731  torch y = x W^T
    mb = lambda b: b.reshape(num_heads, dh)           # noqa: E731
    for i in range(depth):
        p = f"blocks.{i}."
        wq, wk, wv = np.split(f32(sd[p + "attn.qkv.weight"]), 3, axis=0)
        bq, bk, bv = np.split(f32(sd[p + "attn.qkv.bias"]), 3, axis=0)
        block = {
            "norm1": {"scale": f32(sd[p + "norm1.weight"]), "bias": f32(sd[p + "norm1.bias"])},
            "attn": {
                "query": {"kernel": mk(wq), "bias": mb(bq)},
                "key": {"kernel": mk(wk), "bias": mb(bk)},
                "value": {"kernel": mk(wv), "bias": mb(bv)},
                "out": {"kernel": f32(sd[p + "attn.proj.weight"]).T.reshape(num_heads, dh, d),
                        "bias": f32(sd[p + "attn.proj.bias"])},
            },
            "norm2": {"scale": f32(sd[p + "norm2.weight"]), "bias": f32(sd[p + "norm2.bias"])},
            "mlp1": {"kernel": f32(sd[p + "mlp.fc1.weight"]).T,
                     "bias": f32(sd[p + "mlp.fc1.bias"])},
            "mlp2": {"kernel": f32(sd[p + "mlp.fc2.weight"]).T,
                     "bias": f32(sd[p + "mlp.fc2.bias"])},
        }
        if p + "ls1.gamma" in sd:
            block["ls1_gamma"] = f32(sd[p + "ls1.gamma"])
            block["ls2_gamma"] = f32(sd[p + "ls2.gamma"])
        params[f"block{i}"] = block
    return {"params": params}


def timm_vit_forward(sd, images, depth: int, heads: int, patch: int):
    """timm's ViT (pre-norm, fused qkv, exact GELU, optional LayerScale, CLS
    output after the final LayerNorm) straight from a state dict of tensors
    ``sd``; ``images`` [B, H, W, 3] normalized floats on sd's device. The
    position embedding must already be at the images' grid."""
    import torch
    import torch.nn.functional as F
    x = F.conv2d(images.permute(0, 3, 1, 2).float(), sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"], stride=patch)
    b, d = x.shape[:2]
    x = torch.cat([sd["cls_token"].expand(b, -1, -1), x.flatten(2).transpose(1, 2)], 1)
    x = x + sd["pos_embed"]
    dh = d // heads
    for i in range(depth):
        p = f"blocks.{i}."
        h = F.layer_norm(x, (d,), sd[p + "norm1.weight"], sd[p + "norm1.bias"], eps=1e-6)
        q, k, v = (t.view(b, -1, heads, dh).transpose(1, 2) for t in
                   F.linear(h, sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"]).chunk(3, -1))
        h = ((q @ k.transpose(-2, -1)) * dh ** -0.5).softmax(-1) @ v
        h = F.linear(h.transpose(1, 2).reshape(b, -1, d), sd[p + "attn.proj.weight"],
                     sd[p + "attn.proj.bias"])
        if p + "ls1.gamma" in sd:
            h = h * sd[p + "ls1.gamma"]
        x = x + h
        h = F.layer_norm(x, (d,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], eps=1e-6)
        h = F.linear(F.gelu(F.linear(h, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"])),
                     sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
        if p + "ls2.gamma" in sd:
            h = h * sd[p + "ls2.gamma"]
        x = x + h
    return F.layer_norm(x, (d,), sd["norm.weight"], sd["norm.bias"], eps=1e-6)[:, 0]


def save_bundle(path: str | Path, params: Dict, model_config: Dict, extra: Dict) -> Path:
    """The ``named_paths_v2`` npz both packages' ``load_npz_weights`` read
    (stored uncompressed: weights barely compress, and a ViT-B bundle is
    written several times faster)."""
    from ..convert import KEY_PREFIX, flatten_flax
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {KEY_PREFIX + k: v for k, v in flatten_flax(params).items()}
    meta = {"model_config": model_config, "format": "named_paths_v2",
            "num_leaves": len(arrays), "extra": extra}
    np.savez(path, __meta__=json.dumps(meta), **arrays)
    return path


def check_conversion(sd: Dict[str, np.ndarray], params: Dict, arch: str, image_size: int,
                     device, seed: int = 0) -> float:
    """Load ``params`` into the port's ``VisionTransformer`` of ``arch``
    strictly (raises ``CheckpointError`` naming what differs), then return
    the largest |difference| between its f32 features of one seeded image
    and :func:`timm_vit_forward`'s on ``device``."""
    import torch

    from ..convert import encoder_params_from_flax, load_state
    from ..models.vit import _ARCHS, VisionTransformer
    kwargs = _ARCHS[arch][0]
    module = VisionTransformer(**kwargs, image_size=image_size, dtype=torch.float32)
    load_state(module, encoder_params_from_flax(params["params"]))
    module = module.to(device).eval()
    tsd = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in sd.items()}
    tsd["pos_embed"] = torch.as_tensor(params["params"]["pos_embed"], device=device)
    img = torch.as_tensor(np.random.RandomState(seed).randn(1, image_size, image_size, 3)
                          .astype(np.float32), device=device)
    with torch.no_grad():
        ours = module(img)
        ref = timm_vit_forward(tsd, img, kwargs["depth"], kwargs["num_heads"],
                               kwargs["patch_size"])
    return float((ours - ref).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_timm_vit", description=__doc__.splitlines()[0])
    ap.add_argument("input", help="torch state-dict file (.pth/.pt/.bin) or .npz")
    ap.add_argument("output", help="output npz bundle path")
    ap.add_argument("--arch", default="dinov2_b14",
                    help="target arch key of models/vit.py _ARCHS")
    ap.add_argument("--image-size", type=int, default=224,
                    help="inference resolution; the position embedding is resized to it")
    ap.add_argument("--cpu", action="store_true", help="run the check on the CPU")
    args = ap.parse_args(argv)

    from ..models.vit import _ARCHS
    from ..utils.exceptions import CheckpointError
    from . import resolve
    device = resolve(ap, args.cpu)
    kwargs, feat_dim = _ARCHS[args.arch]
    if kwargs is None:
        ap.error(f"--arch {args.arch} has no ViT weights to convert")
    sd = load_torch_state_dict(args.input)
    grid = args.image_size // kwargs["patch_size"]
    params = convert_state_dict(sd, depth=kwargs["depth"], num_heads=kwargs["num_heads"],
                                target_tokens=grid * grid + 1)
    try:
        err = check_conversion(sd, params, args.arch, args.image_size, device)
    except CheckpointError as exc:
        print(f"conversion structure mismatch: {exc}", file=sys.stderr)
        return 1
    if not err <= CHECK_ATOL:
        print(f"converted features differ from the timm forward by {err:.3g} "
              f"(> {CHECK_ATOL})", file=sys.stderr)
        return 1
    save_bundle(args.output, params, {"arch": args.arch, "image_size": args.image_size,
                                      **kwargs},
                extra={"source": str(args.input), "feature_dim": feat_dim})
    print(f"converted {len(sd)} tensors -> {args.output} (check on {device}: "
          f"max |diff| {err:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
