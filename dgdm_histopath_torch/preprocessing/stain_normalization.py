"""Stain normalization, Macenko and Reinhard, batched over patches on the
device.

Counterpart of the JAX package's ``preprocessing/stain_normalization.py``:
RGB -> optical density, transparent pixels dropped (every channel's OD above
0.15), top-2 eigenvectors of the OD covariance, robust angle percentiles
(alpha = 1), unit stain vectors ordered (H, E), concentrations by the 2x2
normal equations, the 99th-percentile concentrations scaled to the reference
H&E maxima, OD -> RGB; Reinhard's LAB mean/std transfer.

Every function takes a leading batch of patches (``[..., P, 3]``); the JAX
package maps a one-patch function over the batch. The products with a
depth of 2 or 3 are written as sums of elementwise products in f32, and the
covariance is summed in f64, so that TF32 never touches them whatever the
global ``torch.backends`` flags say.

Eigenvector signs: ``eigh`` may return either sign for each eigenvector, and
LAPACK and cuSOLVER pick differently. The estimate does not depend on them
(flipping either vector swaps the two robust angles and reflects them, which
the (H, E) ordering undoes), as long as every tissue pixel projects onto the
leading eigenvector with one sign, so that the angles do not wrap at ±π.
Both vectors are turned to a positive sum all the same, so the CPU and the
card work on the same basis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device

# the reference H&E stain matrix [3 rgb, 2 stains] (H, E) and its maximum
# concentrations, the standard Macenko constants
DEFAULT_STAIN_MATRIX = np.array(
    [[0.5626, 0.2159],
     [0.7201, 0.8012],
     [0.4062, 0.5581]], dtype=np.float32)
DEFAULT_MAX_CONCENTRATIONS = np.array([1.9705, 1.0308], dtype=np.float32)

_EPS = 1e-6
_TRANSPARENT_OD = 0.15   # per-channel OD threshold for "tissue" pixels
_IO = 255.0              # transmitted light intensity
F32_MAX = torch.finfo(torch.float32).max


def rgb_to_od(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 255] -> optical density ``-log((I + 1) / 255)``."""
    rgb = torch.clamp(rgb.float(), 0.0, 255.0)
    return -torch.log((rgb + 1.0) / _IO)


def od_to_rgb(od: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_IO * torch.exp(-od) - 1.0, 0.0, 255.0)


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., P, C] @ w [..., C, S] -> [..., P, S]`` for a small C, as f32
    sums of elementwise products in order over C."""
    out = x[..., 0:1] * w[..., None, 0, :]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c:c + 1] * w[..., None, c, :]
    return out


def _percentile_masked(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated percentile over the masked entries of the last
    axis (0 where none is masked): [..., P] -> [...]."""
    filled = torch.where(mask, values, F32_MAX)
    order = torch.sort(filled, dim=-1).values
    n_valid = mask.sum(-1)
    idx = torch.clamp_min((q / 100.0) * (n_valid.float() - 1.0), 0.0)
    lo, hi = torch.floor(idx), torch.ceil(idx)
    frac = idx - lo
    top = values.shape[-1] - 1
    lo_v = torch.gather(order, -1, lo.long().clamp(0, top)[..., None])[..., 0]
    hi_v = torch.gather(order, -1, hi.long().clamp(0, top)[..., None])[..., 0]
    return torch.where(n_valid > 0, lo_v * (1.0 - frac) + hi_v * frac, 0.0)


def quantiles(values: torch.Tensor, qs) -> torch.Tensor:
    """Linear-interpolated quantiles of the last axis (``jnp.quantile``'s
    default method): [..., P] -> [..., len(qs)]. ``torch.quantile`` refuses
    more than 2^24 elements, which a batch of patches exceeds."""
    order = torch.sort(values, dim=-1).values
    out = []
    for q in qs:
        idx = q * (values.shape[-1] - 1)
        lo = int(np.floor(idx))
        hi = min(lo + 1, values.shape[-1] - 1)
        frac = idx - lo
        out.append(order[..., lo] * (1.0 - frac) + order[..., hi] * frac)
    return torch.stack(out, -1)


def _tissue(od: torch.Tensor, beta: float = _TRANSPARENT_OD) -> torch.Tensor:
    return (od > beta).all(-1)


def estimate_stain_matrix(rgb_flat: torch.Tensor, alpha: float = 1.0,
                          beta: float = _TRANSPARENT_OD) -> torch.Tensor:
    """Macenko stain vectors of each image: [..., P, 3] -> [..., 3, 2] (H, E)."""
    od = rgb_to_od(rgb_flat)
    tissue = _tissue(od, beta)
    w = tissue.float()[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)                       # [..., 1]
    mean = (od * w).sum(-2) / n
    centered = ((od - mean[..., None, :]) * w).double()
    cov = centered.mT @ centered / torch.clamp_min(n - 1.0, 1.0).double()[..., None]
    _, evecs = torch.linalg.eigh(cov)
    basis = evecs[..., 1:3]                                   # ascending: the top two
    basis = torch.where(basis.sum(-2, keepdim=True) < 0, -basis, basis).float()
    proj = _mix(od, basis)                                    # [..., P, 2]
    angles = torch.atan2(proj[..., 1], proj[..., 0])
    a_min = _percentile_masked(angles, tissue, alpha)
    a_max = _percentile_masked(angles, tissue, 100.0 - alpha)

    def stain(a):
        v = basis[..., 0] * torch.cos(a)[..., None] + basis[..., 1] * torch.sin(a)[..., None]
        v = torch.where(v.sum(-1, keepdim=True) < 0, -v, v)   # into positive OD space
        return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), _EPS)

    v1, v2 = stain(a_min), stain(a_max)
    first_is_h = (v1[..., 0] > v2[..., 0])[..., None]         # H has the larger red OD
    return torch.stack([torch.where(first_is_h, v1, v2),
                        torch.where(first_is_h, v2, v1)], -1)


def stain_concentrations(rgb_flat: torch.Tensor, stain_matrix: torch.Tensor) -> torch.Tensor:
    """Least-squares unmixing ``od ≈ stain_matrix @ C`` by the 2x2 normal
    equations: [..., P, 3], [..., 3, 2] -> C [..., 2, P]."""
    od = rgb_to_od(rgb_flat)
    m = stain_matrix
    mtm = (m[..., :, :, None] * m[..., :, None, :]).sum(-3)   # [..., 2, 2]
    a, b = mtm[..., 0, 0] + _EPS, mtm[..., 0, 1]
    c, d = mtm[..., 1, 0], mtm[..., 1, 1] + _EPS
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[..., None, None]
    return _mix(_mix(od, m), inv.mT).mT


def macenko_normalize_batch(rgb_batch: torch.Tensor, ref_stains: torch.Tensor,
                            ref_max_c: torch.Tensor, alpha: float = 1.0,
                            stats_pixels: int = 4096) -> torch.Tensor:
    """Macenko-normalize a batch of patches [B, H, W, 3] -> f32 [B, H, W, 3].

    The estimators (stain vectors, 99th-percentile concentrations) use a
    strided sample of at most ``stats_pixels`` pixels of each patch
    (``stats_pixels=0``: every pixel); the transform touches every pixel.
    Non-tissue pixels are kept as they are.
    """
    b, h, w, _ = rgb_batch.shape
    flat = rgb_batch.reshape(b, -1, 3).float()
    p = flat.shape[1]
    sample = flat
    if stats_pixels and p > stats_pixels:
        sample = flat[:, :: p // stats_pixels][:, :stats_pixels]
    stains = estimate_stain_matrix(sample, alpha=alpha)
    conc = stain_concentrations(flat, stains)                 # [B, 2, P]
    tissue = _tissue(rgb_to_od(flat))
    conc_s = stain_concentrations(sample, stains)
    tissue_s = _tissue(rgb_to_od(sample))
    max_c = torch.stack([_percentile_masked(conc_s[:, 0], tissue_s, 99.0),
                         _percentile_masked(conc_s[:, 1], tissue_s, 99.0)], -1)
    scale = ref_max_c / torch.clamp_min(max_c, _EPS)          # [B, 2]
    od_norm = _mix(conc.mT * scale[:, None, :], ref_stains.mT.expand(b, 2, 3))
    out = od_to_rgb(od_norm).reshape(b, h, w, 3)
    return torch.where(tissue.reshape(b, h, w, 1), out, flat.reshape(b, h, w, 3))


# ---------------------------------------------------------------------------
# Reinhard (Ruderman LAB mean/std transfer)
# ---------------------------------------------------------------------------

_RGB2LMS = np.asarray([[0.3811, 0.5783, 0.0402],
                       [0.1967, 0.7244, 0.0782],
                       [0.0241, 0.1288, 0.8444]], np.float32)
_LMS2LAB = (np.asarray([[1 / np.sqrt(3), 0, 0],
                        [0, 1 / np.sqrt(6), 0],
                        [0, 0, 1 / np.sqrt(2)]], np.float32)
            @ np.asarray([[1, 1, 1], [1, 1, -2], [1, -1, 0]], np.float32))
_LAB2LMS = np.linalg.inv(_LMS2LAB.astype(np.float64)).astype(np.float32)
_LMS2RGB = np.linalg.inv(_RGB2LMS.astype(np.float64)).astype(np.float32)

# Ruderman-LAB statistics of a reference H&E tissue field (from the
# synthetic H&E generator); fit_to_template derives cohort-specific ones
DEFAULT_LAB_MEAN = np.array([-0.4375, -0.0260, 0.0212], dtype=np.float32)
DEFAULT_LAB_STD = np.array([0.1723, 0.0507, 0.0075], dtype=np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    rgb01 = torch.clamp(rgb.float() / 255.0, _EPS, 1.0)
    lms = _mix(rgb01, _const(_RGB2LMS.T, rgb01))
    return _mix(torch.log10(torch.clamp_min(lms, _EPS)), _const(_LMS2LAB.T, rgb01))


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    lms = torch.pow(10.0, _mix(lab, _const(_LAB2LMS.T, lab)))
    return torch.clamp(_mix(lms, _const(_LMS2RGB.T, lab)) * 255.0, 0.0, 255.0)


def reinhard_normalize_batch(rgb_batch: torch.Tensor, target_mean: torch.Tensor,
                             target_std: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> f32 [B, H, W, 3] with each patch's LAB mean and std
    moved to the targets."""
    lab = rgb_to_lab(rgb_batch)
    mean = lab.mean(dim=(1, 2), keepdim=True)
    std = torch.clamp_min(lab.std(dim=(1, 2), keepdim=True, correction=0), _EPS)
    return lab_to_rgb((lab - mean) / std * target_std + target_mean)


class StainNormalizer:
    """Batched stain normalizer on ``device`` (``None`` means ``"cuda"``):
    ``normalize()`` and ``fit_to_template()``, as the reference's class."""

    def __init__(self, method: str = "macenko", alpha: float = 1.0,
                 stats_pixels: int = 4096, device=None):
        if method not in ("macenko", "reinhard"):
            raise ValueError(f"unknown stain normalization method {method!r}")
        self.method = method
        self.alpha = float(alpha)
        self.stats_pixels = int(stats_pixels)
        self.device = resolve_device(device)
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.ref_stains = t(DEFAULT_STAIN_MATRIX)
        self.ref_max_c = t(DEFAULT_MAX_CONCENTRATIONS)
        self.lab_mean = t(DEFAULT_LAB_MEAN)
        self.lab_std = t(DEFAULT_LAB_STD)

    def fit_to_template(self, template_rgb: np.ndarray) -> "StainNormalizer":
        """Derive the reference statistics from a template image [H, W, 3]."""
        img = torch.as_tensor(np.asarray(template_rgb), device=self.device)
        flat = img.reshape(-1, 3).float()
        if self.method == "macenko":
            stains = estimate_stain_matrix(flat, alpha=self.alpha)
            conc = stain_concentrations(flat, stains)
            tissue = _tissue(rgb_to_od(flat))
            self.ref_stains = stains
            self.ref_max_c = torch.stack([_percentile_masked(conc[0], tissue, 99.0),
                                          _percentile_masked(conc[1], tissue, 99.0)])
        else:
            lab = rgb_to_lab(img)
            self.lab_mean = lab.mean(dim=(0, 1))
            self.lab_std = lab.std(dim=(0, 1), correction=0)
        return self

    def normalize(self, patches: np.ndarray) -> np.ndarray:
        """Normalize [H, W, 3] or [B, H, W, 3] uint8 patches -> uint8."""
        arr = torch.as_tensor(np.asarray(patches), device=self.device)
        single = arr.dim() == 3
        if single:
            arr = arr[None]
        with torch.inference_mode():
            if self.method == "macenko":
                out = macenko_normalize_batch(arr, self.ref_stains, self.ref_max_c,
                                              alpha=self.alpha, stats_pixels=self.stats_pixels)
            else:
                out = reinhard_normalize_batch(arr, self.lab_mean, self.lab_std)
            out_np = torch.round(out).to(torch.uint8).cpu().numpy()
        return out_np[0] if single else out_np
