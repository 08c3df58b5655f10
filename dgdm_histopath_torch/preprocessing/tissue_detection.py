"""Tissue detection on a low-resolution slide thumbnail.

Counterpart of the JAX package's ``preprocessing/tissue_detection.py``: the
composite mask (grey below the background threshold, Otsu, saturation above
20 and value below 240, after a Gaussian blur), morphological close and
open, the connected-component area filter (scipy, on the host, as in the
reference) and the KMeans(3) detector.

The mask is computed on the device: the blur as two zero-padded 1-D
convolutions, Otsu from a 256-bin histogram of the grey values (bin
``floor(grey)``, the bins of ``jnp.histogram(range=(0, 256))``), erosion
and dilation as max-pooling with infinite padding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] or [H, W, C], zero padding."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    x = img.float().permute(2, 0, 1)[:, None]                  # [C, 1, H, W]
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    out = x[:, 0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    r = rgb.float()
    return r[..., 0] * 0.299 + r[..., 1] * 0.587 + r[..., 2] * 0.114


def rgb_to_hsv_sv(rgb: torch.Tensor):
    """Saturation and value (0-255 scale), without the hue."""
    r = rgb.float()
    mx, mn = r.amax(-1), r.amin(-1)
    s = torch.where(mx > 0, (mx - mn) / torch.clamp_min(mx, 1e-6) * 255.0, 0.0)
    return s, mx


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold (a bin index, as f32) from a 256-bin histogram. The
    between-class variance is taken in f64, so that the CPU and the card
    pick the same bin."""
    bins = torch.floor(torch.clamp(gray, 0, 255)).long().flatten()
    hist = torch.bincount(bins, minlength=256).double()
    p = hist / torch.clamp_min(hist.sum(), 1.0)
    omega = torch.cumsum(p, 0)
    mu = torch.cumsum(p * torch.arange(256, dtype=torch.float64, device=gray.device), 0)
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-9, (mu[-1] * omega - mu) ** 2 / torch.clamp_min(denom, 1e-9),
                          0.0)
    return torch.argmax(sigma_b).float()


def _binary_morph(mask: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """Erode or dilate a boolean [H, W] mask with a size x size window."""
    x = mask.float()[None, None]
    if op == "dilate":
        out = F.max_pool2d(x, size, stride=1, padding=size // 2)
    else:
        out = -F.max_pool2d(-x, size, stride=1, padding=size // 2)
    return out[0, 0] > 0.5


def morph_close(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    return _binary_morph(_binary_morph(mask, size, "dilate"), size, "erode")


def morph_open(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    return _binary_morph(_binary_morph(mask, size, "erode"), size, "dilate")


def compute_tissue_mask(thumbnail: torch.Tensor, bg_threshold: float = 220.0,
                        sat_threshold: float = 20.0, val_threshold: float = 240.0,
                        blur_sigma: float = 2.0, morphology_size: int = 5) -> torch.Tensor:
    """Composite tissue mask of an RGB thumbnail [H, W, 3] -> bool [H, W],
    on the thumbnail's device."""
    img = gaussian_blur(thumbnail.float(), blur_sigma)
    gray = rgb_to_gray(img)
    sat, val = rgb_to_hsv_sv(img)
    # argmax convention: class 0 is bins [0..t] inclusive, so tissue is <= t
    mask = ((gray < bg_threshold) & (gray <= otsu_threshold(gray))
            & (sat > sat_threshold) & (val < val_threshold))
    return morph_open(morph_close(mask, morphology_size), morphology_size)


def connected_components_filter(mask: np.ndarray, min_area: int) -> np.ndarray:
    """Remove 4-connected components smaller than ``min_area`` pixels
    (scipy labelling on the host)."""
    mask = np.asarray(mask, bool)
    if min_area <= 1 or not mask.any():
        return mask.copy()
    from scipy import ndimage
    labeled, n = ndimage.label(mask)
    if n == 0:
        return mask.copy()
    areas = np.bincount(labeled.ravel(), minlength=n + 1)
    areas[0] = 0
    return (areas >= min_area)[labeled]


@dataclass
class TissueStats:
    tissue_fraction: float
    num_regions: int
    largest_region_area: int
    total_tissue_pixels: int


class TissueDetector:
    """Tissue detector with the reference's class API (``detect_tissue``,
    ``get_tissue_stats``). The composite mask runs on ``device`` (``None``
    means ``"cuda"``); the k-means detector and the area filter on the host."""

    def __init__(self, bg_threshold: float = 220.0, sat_threshold: float = 20.0,
                 val_threshold: float = 240.0, blur_sigma: float = 2.0,
                 morphology_size: int = 5, min_region_area: int = 64,
                 method: str = "composite", device=None):
        self.bg_threshold = bg_threshold
        self.sat_threshold = sat_threshold
        self.val_threshold = val_threshold
        self.blur_sigma = blur_sigma
        self.morphology_size = morphology_size
        self.min_region_area = min_region_area
        self.method = method
        self.device = resolve_device(device)

    def detect_tissue(self, thumbnail: np.ndarray) -> np.ndarray:
        """RGB thumbnail [H, W, 3] -> boolean tissue mask [H, W]."""
        if self.method == "kmeans":
            mask = self._detect_kmeans(thumbnail)
        else:
            thumb = torch.as_tensor(np.ascontiguousarray(thumbnail), device=self.device)
            mask = compute_tissue_mask(thumb, self.bg_threshold, self.sat_threshold,
                                       self.val_threshold, self.blur_sigma,
                                       self.morphology_size).cpu().numpy()
        if self.min_region_area > 0:
            mask = connected_components_filter(mask, self.min_region_area)
        return mask

    def _detect_kmeans(self, thumbnail: np.ndarray, k: int = 3) -> np.ndarray:
        """KMeans(3) on RGB; the darkest centroid's cluster is tissue. Uses
        sklearn where it is installed, else a short numpy Lloyd iteration."""
        pixels = thumbnail.reshape(-1, 3).astype(np.float32)
        try:
            from sklearn.cluster import KMeans
            km = KMeans(n_clusters=k, n_init=3, random_state=0).fit(pixels)
            centers, assign = km.cluster_centers_, km.labels_
        except ImportError:
            rs = np.random.RandomState(0)
            centers = pixels[rs.choice(len(pixels), k, replace=False)]
            for _ in range(10):
                d = ((pixels[:, None] - centers[None]) ** 2).sum(-1)
                assign = d.argmin(1)
                for c in range(k):
                    sel = pixels[assign == c]
                    if len(sel):
                        centers[c] = sel.mean(0)
        tissue_cluster = int(np.argmin(centers.mean(axis=1)))
        return (assign == tissue_cluster).reshape(thumbnail.shape[:2])

    def get_tissue_stats(self, mask: np.ndarray) -> TissueStats:
        from scipy import ndimage
        total = int(mask.sum())
        frac = float(total) / float(mask.size) if mask.size else 0.0
        labeled, n = ndimage.label(mask)
        areas = np.bincount(labeled.ravel())[1:]
        return TissueStats(frac, int(n), int(areas.max()) if len(areas) else 0, total)
