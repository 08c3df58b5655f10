"""Synthetic H&E slides for tests and for driving the slide path.

The numpy paths of the JAX package's ``preprocessing/synthetic.py``:
procedurally generated H&E-looking images with known tissue geometry
(``generate_tissue_image``), their pyramids (``build_pyramid``), an
in-memory ``ArrayBackend`` slide (``synthetic_slide``) and a gigapixel tiled
(Big)TIFF written band by band with O(band) memory
(``write_synthetic_slide_tiff``). The same seed gives the same pixels as the
JAX package's generator. The HDF5 writer and the jitted band renderer are
not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .slide_io import ArrayBackend

# H&E-ish colors (RGB)
_BACKGROUND = np.array([244, 242, 245], np.float32)
_EOSIN = np.array([228, 140, 178], np.float32)       # cytoplasm pink
_HEMATOXYLIN = np.array([94, 60, 140], np.float32)   # nuclei purple


def generate_tissue_image(
    width: int = 2048,
    height: int = 2048,
    num_blobs: int = 6,
    nuclei_density: float = 0.002,
    seed: int = 0,
    focal_density: Optional[float] = None,
    focal_frac: float = 0.0,
    stain_jitter: float = 0.0,
    brightness_jitter: float = 0.0,
    noise_sigma: float = 3.0,
    nuclei_radius: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural H&E image. Returns (rgb uint8 [H,W,3], tissue_mask bool).

    Beyond uniform-density rendering it supports:
      * ``focal_density``/``focal_frac`` — ONE elliptical focus covering
        ~``focal_frac`` of the tissue whose nuclei density is
        ``focal_density`` instead of the baseline (a focal lesion or a
        benign mimic, depending on contrast);
      * ``stain_jitter`` — per-image multiplicative perturbation of the
        H&E stain colors (scanner/stain variation);
      * ``brightness_jitter`` / ``noise_sigma`` / ``nuclei_radius`` —
        scanner gain, sensor noise, and apparent nucleus size variation.
    """
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    tissue = np.zeros((height, width), np.float32)
    for _ in range(num_blobs):
        cx = rs.uniform(0.15, 0.85) * width
        cy = rs.uniform(0.15, 0.85) * height
        rx = rs.uniform(0.08, 0.25) * width
        ry = rs.uniform(0.08, 0.25) * height
        theta = rs.uniform(0, np.pi)
        dx = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        dy = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        d = (dx / rx) ** 2 + (dy / ry) ** 2
        tissue = np.maximum(tissue, np.clip(1.5 - d, 0.0, 1.0))
    tissue = np.clip(tissue, 0.0, 1.0)
    # stain/scanner jitter: per-image color-matrix + gain perturbation
    eosin, hema, background = _EOSIN, _HEMATOXYLIN, _BACKGROUND
    if stain_jitter > 0:
        eosin = eosin * rs.uniform(1 - stain_jitter, 1 + stain_jitter, 3)
        hema = hema * rs.uniform(1 - stain_jitter, 1 + stain_jitter, 3)
        background = background * rs.uniform(1 - stain_jitter / 2,
                                             1 + stain_jitter / 2, 3)
    # low-frequency eosin texture
    coarse = rs.rand(height // 32 + 1, width // 32 + 1).astype(np.float32)
    texture = np.kron(coarse, np.ones((32, 32), np.float32))[:height, :width]
    img = background[None, None] * (1 - tissue[..., None]) + (
        (eosin[None, None] * (0.6 + 0.4 * texture[..., None])) * tissue[..., None])

    # one elliptical focal region inside tissue (lesion or benign mimic):
    # nuclei density there is focal_density, baseline elsewhere
    focus = np.zeros((height, width), bool)
    if focal_density is not None and focal_frac > 0:
        ty, tx_ = np.nonzero(tissue > 0.5)
        if len(ty):
            j = rs.randint(len(ty))
            cy, cx = float(ty[j]), float(tx_[j])
            # ellipse area pi*rx*ry ~= focal_frac * tissue area
            area = focal_frac * float((tissue > 0.5).sum())
            r0 = np.sqrt(area / np.pi)
            ar = rs.uniform(0.6, 1.6)
            rx, ry = r0 * ar, r0 / ar
            theta = rs.uniform(0, np.pi)
            dx = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
            dy = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
            focus = (((dx / max(rx, 1.0)) ** 2 + (dy / max(ry, 1.0)) ** 2)
                     <= 1.0) & (tissue > 0.5)

    def _stamp_nuclei(region_mask: np.ndarray, density: float) -> None:
        n = int(density * region_mask.sum())
        if n <= 0:
            return
        ys, xs = np.nonzero(region_mask)
        if not len(ys):
            return
        pick = rs.choice(len(ys), min(n, len(ys)), replace=False)
        r = nuclei_radius
        for y, x in zip(ys[pick], xs[pick]):
            y0, y1 = max(0, y - r), min(height, y + r + 1)
            x0, x1 = max(0, x - r), min(width, x + r + 1)
            img[y0:y1, x0:x1] = hema

    _stamp_nuclei((tissue > 0.5) & ~focus, nuclei_density)
    if focus.any():
        _stamp_nuclei(focus, focal_density)
    if brightness_jitter > 0:
        img = img * rs.uniform(1 - brightness_jitter, 1 + brightness_jitter)
    noise = rs.randn(height, width, 3).astype(np.float32) * noise_sigma
    img = np.clip(img + noise, 0, 255).astype(np.uint8)
    return img, tissue > 0.3


def build_pyramid(level0: np.ndarray, num_levels: int = 4) -> List[np.ndarray]:
    """2× downsampled pyramid via box averaging."""
    levels = [level0]
    cur = level0.astype(np.float32)
    for _ in range(num_levels - 1):
        h, w = cur.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        cur = cur[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean(axis=(1, 3))
        levels.append(np.clip(cur, 0, 255).astype(np.uint8))
    return levels


def synthetic_slide(
    width: int = 2048,
    height: int = 2048,
    num_levels: int = 4,
    objective_power: float = 20.0,
    seed: int = 0,
    **kw,
) -> Tuple[ArrayBackend, np.ndarray]:
    """In-memory synthetic pyramid. Returns (backend, level0_tissue_mask)."""
    img, mask = generate_tissue_image(width, height, seed=seed, **kw)
    levels = build_pyramid(img, num_levels)
    backend = ArrayBackend(levels, properties={
        "openslide.objective-power": str(objective_power),
        "synthetic": "true",
    })
    return backend, mask


def _make_blobs(rs: np.random.RandomState, width: int, height: int,
                num_blobs: int) -> List[Tuple[float, float, float, float, float]]:
    blobs = []
    for _ in range(num_blobs):
        cx = rs.uniform(0.15, 0.85) * width
        cy = rs.uniform(0.15, 0.85) * height
        rx = rs.uniform(0.04, 0.18) * width
        ry = rs.uniform(0.04, 0.18) * height
        theta = rs.uniform(0, np.pi)
        blobs.append((cx, cy, rx, ry, theta))
    return blobs


def _render_tile(tx: int, ty: int, w: int, h: int, blobs, coarse: np.ndarray,
                 rs_tile: np.random.RandomState,
                 nuclei_density: float) -> np.ndarray:
    """Render one level-0 tile (global coords) from analytic blob params —
    O(tile) memory regardless of slide size."""
    yy, xx = np.mgrid[ty:ty + h, tx:tx + w].astype(np.float32)
    tissue = np.zeros((h, w), np.float32)
    for cx, cy, rx, ry, theta in blobs:
        dx = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        dy = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        d = (dx / rx) ** 2 + (dy / ry) ** 2
        tissue = np.maximum(tissue, np.clip(1.5 - d, 0.0, 1.0))
    texture = coarse[np.ix_(np.arange(ty, ty + h) // 32,
                            np.arange(tx, tx + w) // 32)]
    img = _BACKGROUND[None, None] * (1 - tissue[..., None]) + (
        (_EOSIN[None, None] * (0.6 + 0.4 * texture[..., None])) * tissue[..., None])
    n_nuclei = int(nuclei_density * tissue.sum())
    if n_nuclei > 0:
        ys, xs = np.nonzero(tissue > 0.5)
        if len(ys):
            pick = rs_tile.choice(len(ys), min(n_nuclei, len(ys)), replace=False)
            r = 3
            for y, x in zip(ys[pick], xs[pick]):
                img[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = _HEMATOXYLIN
    img = img + rs_tile.randn(h, w, 3).astype(np.float32) * 3.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _render_band_numpy(ty: int, band: int, width: int, num_levels: int,
                       blobs, coarse: np.ndarray, nuclei_density: float,
                       seed: int) -> List[np.ndarray]:
    """Host fallback for one level-0 row band + its pyramid reductions."""
    chunks = []
    for tx in range(0, width, 2048):
        w = min(2048, width - tx)
        rs_tile = np.random.RandomState(
            (seed * 1000003 + (ty // band) * 8191 + tx // 2048) % (2 ** 31))
        chunks.append(_render_tile(tx, ty, w, band, blobs, coarse, rs_tile,
                                   nuclei_density))
    out0 = np.concatenate(chunks, axis=1)
    outs = [out0]
    cur = out0.astype(np.float32)
    for _ in range(1, num_levels):
        h, w = cur.shape[:2]
        cur = cur.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
        outs.append(np.clip(cur, 0, 255).astype(np.uint8))
    return outs


def write_synthetic_slide_tiff(
    path: str | Path,
    width: int = 24576,
    height: int = 24576,
    num_levels: int = 5,
    band: int = 2048,
    tiff_tile: int = 256,
    seed: int = 0,
    compression: str = "jpeg",
    jpeg_quality: int = 85,
    num_blobs: int = 24,
    nuclei_density: float = 5e-4,
    objective_power: float = 20.0,
) -> Path:
    """Stream a synthetic H&E pyramid to a tiled BigTIFF in the Aperio
    layout (256-px tiles, ``AppMag`` in the ImageDescription) with O(band)
    memory, rendering each level-0 row band on the host. ``compression``:
    ``"jpeg"`` (through Pillow), ``"deflate"``, ``"lzw"`` or ``"raw"``."""
    from .tiff import StreamingTiledTiffWriter
    path = Path(path)
    div = 1 << (num_levels - 1)
    if width % div or height % band or band % div or width % tiff_tile:
        raise ValueError(
            f"width ({width}) must divide by 2^(levels-1) ({div}) and "
            f"tiff_tile ({tiff_tile}); height ({height}) by band ({band}); "
            f"band by {div}")
    rs = np.random.RandomState(seed)
    blobs = _make_blobs(rs, width, height, num_blobs)
    coarse = rs.rand(height // 32 + 2, width // 32 + 2).astype(np.float32)
    level_dims = [(height >> lvl, width >> lvl) for lvl in range(num_levels)]
    desc = (f"Aperio Synthetic (dgdm fixture)|AppMag = {objective_power:g}"
            f"|MPP = 0.5000")
    writer = StreamingTiledTiffWriter(
        path, level_dims, tile=tiff_tile, compression=compression,
        bigtiff=True, jpeg_quality=jpeg_quality, description=desc)
    bufs = [np.zeros((0, width >> lvl, 3), np.uint8) for lvl in range(num_levels)]

    def flush(lvl: int, final: bool) -> None:
        tt = tiff_tile
        while bufs[lvl].shape[0] >= tt or (final and bufs[lvl].shape[0]):
            strip, bufs[lvl] = bufs[lvl][:tt], bufs[lvl][tt:]
            for tx in range(0, strip.shape[1], tt):
                writer.write_tile(lvl, strip[:, tx:tx + tt])
            if final and not bufs[lvl].shape[0]:
                break

    bands = list(range(0, height, band))
    for bi, ty in enumerate(bands):
        outs = _render_band_numpy(ty, band, width, num_levels, blobs, coarse,
                                  nuclei_density, seed)
        last = bi == len(bands) - 1
        for lvl, arr in enumerate(outs):
            bufs[lvl] = np.concatenate([bufs[lvl], arr], axis=0)
            flush(lvl, final=last)
    return writer.close()
