"""Patch featurizer: a Vision Transformer (DINOv2-class), a small conv
encoder, and deterministic stain statistics.

Counterpart of the JAX package's ``models/vit.py``. ``PatchFeatureExtractor``
runs the whole preprocessing chain on the device, one call per batch of
patches: uint8 upload, batched Macenko stain normalization (optional), the
antialiased bilinear resize to the encoder's input size, ImageNet
normalization and the encoder.

Numerics follow the flax modules: LayerNorm eps 1e-6; exact (erf) GELU in
the ViT and the tanh GELU in the conv encoder (``flax.linen.gelu``'s
default); the patch embedding a stride-p convolution whose output tokens run
row-major over the patch grid; a CLS token and learned position embeddings;
the encoder output the final LayerNorm of the CLS token, in f32. The resize
is the triangle-kernel weight matrix of ``jax.image.resize(method=
"bilinear")`` (antialiased when downscaling) applied as two products.

Weights are random from a seed unless given (a state dict, e.g. from
``convert.encoder_params_from_flax``) or loaded with ``load_npz_weights``.
"""

from __future__ import annotations

import functools
import logging
import math
import warnings
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..nn.layers import Dense, DenseGeneral, LayerNorm, as_dtype, gelu, init_parameters
from ..preprocessing.stain_normalization import (
    DEFAULT_MAX_CONCENTRATIONS,
    DEFAULT_STAIN_MATRIX,
    _mix,
    macenko_normalize_batch,
    quantiles,
    rgb_to_od,
)
from ..utils.device import resolve_device
from .vit_int8 import quantize_vit_params, vit_int8_forward

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# dimensionality of stain_stat_features (any arch + "+stats" suffix)
STAIN_STATS_DIM = 14


def stain_stat_features(x: torch.Tensor) -> torch.Tensor:
    """Per-patch H&E stain statistics [B, 14] of float [B, S, S, 3] in
    [0, 255]: each pixel's OD projected on the reference H&E basis, then the
    mean, std, p50 / p90 / p99 of the hematoxylin and eosin concentrations,
    the fractions of pixels with hematoxylin above 0.6 and 1.0, and the
    grey mean and std."""
    b = x.shape[0]
    flat = x.reshape(b, -1, 3).float()
    pinv = torch.as_tensor(np.linalg.pinv(DEFAULT_STAIN_MATRIX), device=x.device)  # [2, 3]
    conc = _mix(rgb_to_od(flat), pinv.T)                     # [B, P, 2]
    h, e = conc[..., 0], conc[..., 1]
    gray = flat.mean(-1) / 255.0
    qs = (0.5, 0.9, 0.99)
    one = lambda v: v[..., None]  # noqa: E731
    return torch.cat([
        one(h.mean(-1)), one(h.std(-1, correction=0)), quantiles(h, qs),
        one(e.mean(-1)), one(e.std(-1, correction=0)), quantiles(e, qs),
        one((h > 0.6).float().mean(-1)), one((h > 1.0).float().mean(-1)),
        one(gray.mean(-1)), one(gray.std(-1, correction=0)),
    ], -1).float()


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW tensors: "SAME" padding (the extra row and
    column, if any, at the end), computing in ``dtype``; f32 parameters."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        with torch.no_grad():          # values come from init_encoder or a checkpoint
            self.weight.zero_()
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size),
                              reversed(self.stride)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        dt = self.compute_dtype
        return F.conv2d(F.pad(x.to(dt), pads), self.weight.to(dt), self.bias.to(dt),
                        self.stride)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask):
    query / key / value / out projections."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value = (DenseGeneral(dim, dim, dtype=dtype)
                                            for _ in range(3))
        self.out = DenseGeneral(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = (p(x).view(b, t, self.num_heads, -1).transpose(1, 2)
                   for p in (self.query, self.key, self.value))
        # f32 through the plain formulation, so that no fused kernel trades
        # precision; bf16 through whichever fused kernel the device has
        backends = ([SDPBackend.MATH] if q.dtype == torch.float32 else
                    [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                     SDPBackend.MATH])
        with sdpa_kernel(backends):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, t, d))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.mlp2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)
        self.layer_scale = layer_scale
        if layer_scale:                # DINOv2 LayerScale
            self.ls1_gamma = nn.Parameter(torch.full((dim,), 1e-5))
            self.ls2_gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        if self.layer_scale:
            h = h * self.ls1_gamma.to(h.dtype)
        x = x + h
        h = self.mlp2(F.gelu(self.mlp1(self.norm2(x))))      # exact GELU
        if self.layer_scale:
            h = h * self.ls2_gamma.to(h.dtype)
        return x + h


class VisionTransformer(nn.Module):
    """Conv patch embedding + CLS token + transformer stack; images
    [B, H, W, 3] (normalized floats) -> CLS embeddings [B, D] f32."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, mlp_ratio: float = 4.0, layer_scale: bool = False,
                 image_size: int = 224, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = Conv(3, embed_dim, patch_size, patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        self.depth = depth
        for i in range(depth):         # flax's names, so the state dict keys match
            self.add_module(f"block{i}", TransformerBlock(embed_dim, num_heads, mlp_ratio,
                                                          layer_scale, dtype))
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.permute(0, 3, 1, 2))      # [B, D, gh, gw]
        x = x.flatten(2).transpose(1, 2)                       # tokens row-major
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)[:, 0].float()


class SimpleConvEncoder(nn.Module):
    """Four stride-2 3x3 convolutions (64, 128, 256, 512) with tanh GELU,
    global average pool, a Dense to ``embed_dim``."""

    def __init__(self, embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        chans = (3, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv{i}", Conv(chans[i], chans[i + 1], 3, 2, dtype=dtype))
        self.proj = Dense(512, embed_dim, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for i in range(4):
            x = gelu(getattr(self, f"conv{i}")(x))
        return self.proj(x.mean(dim=(2, 3))).float()


@torch.no_grad()
def init_encoder(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization with flax's defaults: Dense and Conv kernels
    lecun-normal (truncated, variance 1 / fan_in), biases zero, LayerNorm
    ones / zeros, the CLS token and position embeddings N(0, 0.02),
    LayerScale 1e-5."""
    init_parameters(module, generator)
    for m in module.modules():
        if isinstance(m, Conv):
            std = math.sqrt(1.0 / (m.weight[0].numel())) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.bias.zero_()
    for name, p in module.named_parameters():
        if name in ("cls_token", "pos_embed"):
            p.normal_(0.0, 0.02, generator=generator)
    return module


_ARCHS = {
    # name -> (VisionTransformer kwargs or None, feature dim)
    "dinov2": (dict(embed_dim=768, depth=12, num_heads=12, patch_size=16), 768),
    # the geometry of timm's vit_base_patch14_dinov2: patch 14, LayerScale
    "dinov2_b14": (dict(embed_dim=768, depth=12, num_heads=12, patch_size=14,
                        layer_scale=True), 768),
    "vit_small": (dict(embed_dim=384, depth=12, num_heads=6, patch_size=16), 384),
    "simple_cnn": (None, 512),
    # deterministic stain statistics alone (stain_stat_features)
    "stats": (None, STAIN_STATS_DIM),
}


def vit_flops(image_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
              depth: int = 12, mlp_ratio: float = 4.0) -> int:
    """Operations (2 per multiply-add) of one ViT forward: the patch
    embedding and each block's four projections, two MLP products and two
    attention products."""
    t, d = (image_size // patch_size) ** 2 + 1, embed_dim
    embed = 2 * (t - 1) * (3 * patch_size ** 2) * d
    block = 2 * t * d * d * (4 + 2 * mlp_ratio) + 4 * t * t * d
    return int(embed + depth * block)


@functools.lru_cache(maxsize=8)
def _triangle_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """Antialiased triangle-kernel resize weights [in_size, out_size], in f32
    arithmetic as ``jax.image.resize`` forms them (its sample positions
    round in f32: at 256 px one ulp is 1.5e-5, which moves a weight by as
    much, and an output pixel by up to ~4e-3 against f64 weights)."""
    f = np.float32
    inv_scale = f(1.0) / (f(out_size) / f(in_size))
    kernel_scale = max(inv_scale, f(1.0))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    w = np.maximum(f(0.0), f(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000 * np.finfo(f).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def resize_bilinear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Antialiased bilinear resize of square images [B, S, S, C] (f32) to
    [B, out, out, C]: the triangle weight matrix applied to rows, then to
    columns."""
    w = torch.as_tensor(_triangle_weight_mat(x.shape[1], out_size), device=x.device)
    y = torch.einsum("nijc,ik->nkjc", x, w)
    return torch.einsum("nkjc,jm->nkmc", y, w)


def host_resize_u8(batch: np.ndarray, out_size: int) -> np.ndarray:
    """Antialiased bilinear resize of uint8 patches [N, S, S, 3] on the host:
    Pillow's resampler where installed, else the same triangle weights in
    numpy."""
    n, s = batch.shape[0], batch.shape[1]
    if s == out_size:
        return batch
    try:
        from PIL import Image
    except ImportError:
        w = _triangle_weight_mat(s, out_size)
        x = np.einsum("nijc,ik->nkjc", batch.astype(np.float32), w, optimize=True)
        x = np.einsum("nkjc,jm->nkmc", x, w, optimize=True)
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    for i in range(n):
        out[i] = np.asarray(Image.fromarray(batch[i]).resize(
            (out_size, out_size), Image.Resampling.BILINEAR))
    return out


def check_quant(arch: str, quant: Optional[str]) -> None:
    """The JAX extractor's checks of ``quant`` for ``arch``: int8 needs a ViT
    arch, and the only mode is ``"int8"``."""
    base = arch[: -len("+stats")] if arch.endswith("+stats") else arch
    base = base if base in _ARCHS else "dinov2"
    if quant and base == "stats":
        raise ValueError("quant='int8' requires a ViT arch (stats has no weights to quantize)")
    if quant and base == "simple_cnn":
        raise ValueError("quant='int8' requires a ViT arch (simple_cnn has no quantized path)")
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (None or 'int8')")


class PatchFeatureExtractor:
    """Batched patch featurization on ``device`` (``None`` means ``"cuda"``):
    ``extract(patches uint8 [N, S, S, 3]) -> features [N, D] f32``.

    ``arch``: ``"dinov2"`` (ViT-B/16), ``"dinov2_b14"``, ``"vit_small"``,
    ``"simple_cnn"`` or ``"stats"``; ``"<arch>+stats"`` appends
    :func:`stain_stat_features`; an unknown name means ``"dinov2"``, as in the
    reference. ``dtype``: the encoder's compute dtype. ``params``: a state
    dict for the encoder (random from ``seed`` without one). ``quant="int8"``
    (ViT archs only) runs the encoder through :func:`.vit_int8.vit_int8_forward`
    on weights quantized once per load.
    """

    def __init__(self, arch: str = "dinov2", batch_size: int = 256, seed: int = 0,
                 image_size: int = 224, params: Optional[Mapping[str, torch.Tensor]] = None,
                 stain_normalize_on_device: bool = False, stain_alpha: float = 1.0,
                 stain_stats_pixels: int = 4096, host_resize_upload: bool = False,
                 quant: Optional[str] = None, device=None, dtype: str = "bfloat16"):
        check_quant(arch, quant)
        self.quant = quant
        self.append_stain_stats = arch.endswith("+stats")
        if self.append_stain_stats:
            arch = arch[: -len("+stats")]
        if arch not in _ARCHS:
            arch = "dinov2"
        self.arch = arch + ("+stats" if self.append_stain_stats else "")
        kwargs, self.feature_dim = _ARCHS[arch]
        if self.append_stain_stats:
            self.feature_dim += STAIN_STATS_DIM
        self.batch_size = batch_size
        self.image_size = image_size
        self.host_resize_upload = host_resize_upload
        self.stain_normalize_on_device = stain_normalize_on_device
        self.stain_alpha = stain_alpha
        self.stain_stats_pixels = stain_stats_pixels
        self.device = resolve_device(device)
        dt = as_dtype(dtype)
        if arch == "stats":
            self.module = None
        elif arch == "simple_cnn":
            self.module = SimpleConvEncoder(dtype=dt)
        else:
            self.module = VisionTransformer(**kwargs, image_size=image_size, dtype=dt)
        # the stats arch has no weights: never "random init"
        self.weights_loaded = params is not None or self.module is None
        if self.module is not None:
            if params is None:
                init_encoder(self.module, torch.Generator().manual_seed(seed))
            else:
                from ..convert import load_state
                load_state(self.module, params)
            self.module = self.module.to(self.device).eval()
        self._refresh_quant_params()
        self._warned_random_init = False
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self._ref_stains, self._ref_max_c = t(DEFAULT_STAIN_MATRIX), t(DEFAULT_MAX_CONCENTRATIONS)
        self._mean, self._std = t(IMAGENET_MEAN), t(IMAGENET_STD)

    def _refresh_quant_params(self) -> None:
        """(Re)build the int8 encoder parameters from the module's weights:
        once per weight load."""
        self._qparams = quantize_vit_params(self.module) if self.quant == "int8" else None

    def fused_forward(self, patches_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] on the device -> features [B, D] f32."""
        x = patches_u8.float()
        if self.stain_normalize_on_device:
            x = macenko_normalize_batch(x, self._ref_stains, self._ref_max_c,
                                        self.stain_alpha, self.stain_stats_pixels)
        if self.module is None:
            return stain_stat_features(x)
        stats = stain_stat_features(x) if self.append_stain_stats else None
        if x.shape[1] != self.image_size:
            x = resize_bilinear(x, self.image_size)
        x = (x / 255.0 - self._mean) / self._std
        feats = vit_int8_forward(self._qparams, x) if self.quant == "int8" else self.module(x)
        return feats if stats is None else torch.cat([feats, stats], -1)

    def extract(self, patches: np.ndarray) -> np.ndarray:
        """Featurize every patch, ``batch_size`` at a time, with one fetch."""
        if len(patches) == 0:
            return np.zeros((0, self.feature_dim), np.float32)
        if not self.weights_loaded and not self._warned_random_init:
            msg = (f"PatchFeatureExtractor(arch={self.arch!r}) is running with "
                   "random weights: its embeddings carry no pathology meaning. "
                   "Pass params= or call load_npz_weights().")
            warnings.warn(msg, UserWarning, stacklevel=2)
            logger.warning(msg)
            self._warned_random_init = True
        patches = np.ascontiguousarray(patches, np.uint8)
        return self.materialize([self.dispatch(patches[i:i + self.batch_size])
                                 for i in range(0, len(patches), self.batch_size)])

    def dispatch(self, chunk: np.ndarray) -> torch.Tensor:
        """Featurize one chunk without waiting for the device: the features
        stay on it until :meth:`materialize`."""
        chunk = np.ascontiguousarray(chunk, np.uint8)
        if self.host_resize_upload and chunk.shape[1] != self.image_size:
            chunk = host_resize_u8(chunk, self.image_size)
        with torch.inference_mode():
            return self.fused_forward(torch.from_numpy(chunk).to(self.device))

    @staticmethod
    def materialize(pending) -> np.ndarray:
        """Concatenate dispatched results on the device and fetch them once."""
        if not pending:
            return np.zeros((0, 0), np.float32)
        return torch.cat(pending).cpu().numpy()

    def load_npz_weights(self, path: str) -> None:
        """Load encoder weights from a JAX ``save_model_bundle`` npz (its
        ``p:params/...`` arrays), strictly."""
        from ..convert import KEY_PREFIX, load_state, params_from_flax
        with np.load(path, allow_pickle=False) as data:
            flat = {k[len(KEY_PREFIX):]: data[k] for k in data.files
                    if k.startswith(KEY_PREFIX)}
        load_state(self.module, params_from_flax(flat))
        self.weights_loaded = True
        self._refresh_quant_params()
