"""Synthetic H&E slides for tests and for driving the slide path.

Counterpart of the JAX package's ``preprocessing/synthetic.py``:
procedurally generated H&E-looking images with known tissue geometry
(``generate_tissue_image``), the calibrated hard task's parameters
(``HARD_TASK_DEFAULTS``, ``HARD_MULTICLASS_BANDS``,
``sample_hard_slide_params``), pyramids (``build_pyramid``), an in-memory
``ArrayBackend`` slide (``synthetic_slide``), a Pillow multi-page TIFF
(``write_synthetic_tiff``), and gigapixel slides written band by band with
O(band) memory: a dgdm_wsi HDF5 slide (``write_synthetic_slide_hdf5``) and
a tiled BigTIFF (``write_synthetic_slide_tiff``).

The gigapixel writers take ``device``: ``None`` or ``"auto"`` is the card
(``utils.device.resolve_device``; raises without one), ``"numpy"`` the JAX
package's host path pixel for pixel, and a torch device (``"cpu"``,
``"cuda"``) the band renderer in PyTorch on that device. The host path gives
the JAX package's pixels for the same seed. The band renderer draws its
random fields from a ``torch.Generator``, so its pixels are not the JAX
device renderer's (another generator); fed the same fields,
:func:`render_band` equals the JAX renderer within one uint8 step.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
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


# The calibrated hard stand-in task: one source of the per-slide generation
# parameters, shared by the dataset generator and the oracle separability
# probe so that a calibration transfers as it is (the JAX package's values).
HARD_TASK_DEFAULTS = dict(
    base_density=(0.0030, 0.0090),   # per-slide baseline, log-uniform (3x)
    lesion_contrast=(2.1, 2.7),      # tumor focus density / own baseline
    mimic_contrast=(1.2, 1.7),       # benign focus on normal slides
    lesion_frac=(0.06, 0.14),        # focus area as fraction of tissue
    mimic_frac=(0.05, 0.12),
    stain_jitter=0.15,               # per-slide H&E color-matrix jitter
    brightness_jitter=0.08,          # scanner gain
    noise_sigma=(2.0, 5.0),          # sensor noise, per-slide uniform
    nuclei_radius=(2, 3, 3, 4),      # apparent nucleus size, per-slide
)

# Ordinal focal-contrast bands of the hard multi-class stand-in (a 4-subtype
# analogue): class k's focus sits at band k times the slide's own baseline
# density. The upper bands widen geometrically because the measured
# contrast compresses at high density (overlapping nuclei saturate it).
HARD_MULTICLASS_BANDS = (
    (1.1, 1.4),     # barely above baseline (mimic territory)
    (1.8, 2.2),
    (3.0, 3.5),
    (4.8, 5.6),
)


def sample_hard_slide_params(rs: np.random.RandomState, tumor: bool,
                             size: int = 1024, seed: int = 0, **overrides) -> dict:
    """One slide's render kwargs for the calibrated hard task: ``rs`` draws
    the task-level values (baseline density, contrast, focus size, nuisance
    magnitudes), ``seed`` seeds the renderer's own texture and geometry.
    Returns kwargs for :func:`generate_tissue_image` /
    :func:`write_synthetic_tiff`."""
    cfg = dict(HARD_TASK_DEFAULTS)
    cfg.update(overrides)
    base = float(np.exp(rs.uniform(np.log(cfg["base_density"][0]),
                                   np.log(cfg["base_density"][1]))))
    lo, hi = cfg["lesion_contrast"] if tumor else cfg["mimic_contrast"]
    focal = base * rs.uniform(lo, hi)
    frac = rs.uniform(*(cfg["lesion_frac"] if tumor else cfg["mimic_frac"]))
    return dict(
        width=size, height=size, seed=seed,
        nuclei_density=base, focal_density=focal, focal_frac=float(frac),
        stain_jitter=cfg["stain_jitter"], brightness_jitter=cfg["brightness_jitter"],
        noise_sigma=float(rs.uniform(*cfg["noise_sigma"])),
        nuclei_radius=int(rs.choice(list(cfg["nuclei_radius"]))),
    )


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


def band_tissue(blobs: torch.Tensor, ty: int, band: int, width: int) -> torch.Tensor:
    """The tissue field [band, width] (f32) of the level-0 row band that
    starts at row ``ty``: the largest ``clip(1.5 - d, 0, 1)`` over the
    blobs, ``d`` each ellipse's normalized squared distance. ``blobs``
    [B, 5] (cx, cy, rx, ry, theta) on the render device."""
    dev = blobs.device
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    yy = (torch.arange(band, dtype=torch.float32, device=dev) + float(ty))[:, None]
    tissue = torch.zeros((band, width), dtype=torch.float32, device=dev)
    cos, sin = torch.cos(blobs[:, 4]), torch.sin(blobs[:, 4])
    for i in range(blobs.shape[0]):
        cx, cy, rx, ry = blobs[i, 0], blobs[i, 1], blobs[i, 2], blobs[i, 3]
        dx = (xx - cx) * cos[i] + (yy - cy) * sin[i]
        dy = -(xx - cx) * sin[i] + (yy - cy) * cos[i]
        d = (dx / rx) ** 2 + (dy / ry) ** 2
        tissue = torch.maximum(tissue, (1.5 - d).clamp(0.0, 1.0))
    return tissue


def render_band(blobs: torch.Tensor, coarse: torch.Tensor, ty: int, uniform: torch.Tensor,
                normal: torch.Tensor, nuclei_density: float, num_levels: int
                ) -> List[torch.Tensor]:
    """One level-0 row band and its pyramid levels, uint8 [band >> l,
    width >> l, 3] for each level l, from the two random fields the band
    takes: ``uniform`` [band, width] in [0, 1) and ``normal`` [band, width,
    3] standard normal (the core of the JAX package's jitted band renderer,
    ``_device_band_renderer``, on the fields' device).

    Tissue from the blobs, the eosin texture gathered from ``coarse`` (one
    value per 32 px), nuclei where ``uniform < nuclei_density`` inside
    tissue (> 0.5) dilated by a 7 x 7 window (a max-pool, stride 1, padding
    3: ``reduce_window`` add > 0 over "SAME"), noise ``3 * normal``, and each
    2x level the box mean of the previous level's float image, clipped and
    truncated to uint8."""
    band, width = uniform.shape
    dev = uniform.device
    tissue = band_tissue(blobs, ty, band, width)
    rows = torch.div(torch.arange(band, device=dev) + int(ty), 32, rounding_mode="floor")
    cols = torch.div(torch.arange(width, device=dev), 32, rounding_mode="floor")
    texture = coarse[rows][:, cols]
    bg, eo, he = (torch.as_tensor(c, device=dev) for c in (_BACKGROUND, _EOSIN, _HEMATOXYLIN))
    t3 = tissue[..., None]
    img = bg * (1 - t3) + eo * (0.6 + 0.4 * texture[..., None]) * t3
    centers = ((uniform < nuclei_density) & (tissue > 0.5)).to(torch.float32)
    nucleus = F.max_pool2d(centers[None, None], 7, stride=1, padding=3)[0, 0] > 0
    img = torch.where(nucleus[..., None], he, img)
    img = img + normal * 3.0
    outs = [img.clamp(0, 255).to(torch.uint8)]
    cur = img
    for _ in range(1, num_levels):
        h, w = cur.shape[:2]
        cur = cur.reshape(h // 2, 2, w // 2, 2, 3).mean(dim=(1, 3))
        outs.append(cur.clamp(0, 255).to(torch.uint8))
    return outs


def draw_band_fields(band: int, width: int, seed: int, band_index: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniform [band, width] and normal [band, width, 3] fields of one
    band, drawn on ``device`` by a generator seeded from the slide's seed
    and the band's index (where JAX folds the index into its key)."""
    state = np.random.SeedSequence([seed, band_index]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    uniform = torch.rand((band, width), generator=gen, device=device)
    normal = torch.randn((band, width, 3), generator=gen, device=device)
    return uniform, normal


def _device_band_renderer(width: int, band: int, num_levels: int, nuclei_density: float,
                          device: torch.device, seed: int):
    """``render(blobs, coarse, ty, band_index)`` -> the band's levels on
    ``device``, its random fields drawn there (:func:`draw_band_fields`)."""

    def render(blobs, coarse, ty, band_index):
        uniform, normal = draw_band_fields(band, width, seed, band_index, device)
        return render_band(blobs, coarse, ty, uniform, normal, nuclei_density, num_levels)

    return render


def _render_device(device, check: Tuple[int, int, int], num_levels: int, band_name: str):
    """The render device of ``device`` (None for ``"numpy"``), after the
    check that (width, height, band) split cleanly, which the band renderer
    needs."""
    if device == "numpy":
        return None
    width, height, band = check
    div = 1 << (num_levels - 1)
    if width % div or height % band or band % div:
        raise ValueError(
            f"the band renderer needs width ({width}) and {band_name} ({band}) divisible by "
            f"2^(levels-1) ({div}) and height ({height}) divisible by {band_name}; "
            f"device='numpy' renders any shape")
    return resolve_device(None if device == "auto" else device)


def write_synthetic_slide_hdf5(
    path: str | Path,
    width: int = 20480,
    height: int = 20480,
    num_levels: int = 5,
    tile: int = 2048,
    seed: int = 0,
    objective_power: float = 20.0,
    num_blobs: int = 24,
    nuclei_density: float = 5e-4,
    compression_opts: int = 2,
    compression: Optional[str] = "gzip",
    chunk_px: int = 512,
    device=None,
) -> Path:
    """Stream a synthetic H&E pyramid to a dgdm_wsi HDF5 slide
    (``slide_io.HDF5SlideBackend``) with O(band) host memory: one row band
    of ``tile`` rows at a time, every pyramid level from the same band.

    ``device``: the card by default (``None`` / ``"auto"``: one render a
    band, the host only compresses; raises without a card); ``"numpy"`` the
    JAX package's host path (the same bytes); ``"cpu"`` / ``"cuda"`` the
    band renderer there. The band renderer raises a ValueError unless width
    and ``tile`` divide by 2^(levels-1) and height by ``tile``. Chunks are
    ``chunk_px``² (a 256² patch then inflates at most 4 small chunks). The
    file is written under a temporary name and renamed, so a killed run
    leaves no truncated slide."""
    import json
    import os

    import h5py
    dev = _render_device(device, (width, height, tile), num_levels, "tile")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    rs = np.random.RandomState(seed)
    blobs = _make_blobs(rs, width, height, num_blobs)
    coarse = rs.rand(height // 32 + 2, width // 32 + 2).astype(np.float32)
    with h5py.File(tmp, "w") as f:
        f.attrs["dgdm_wsi"] = "1"
        f.attrs["properties"] = json.dumps({
            "openslide.objective-power": str(objective_power),
            "synthetic": "true", "seed": str(seed)})
        comp = dict(compression=compression,
                    compression_opts=compression_opts if compression == "gzip" else None,
                    chunk_px=chunk_px)
        if dev is None:
            _write_levels_numpy(f, width, height, num_levels, tile, seed, blobs, coarse,
                                nuclei_density, comp)
        else:
            _write_levels_device(f, width, height, num_levels, tile, seed, blobs, coarse,
                                 nuclei_density, comp, dev)
    os.replace(tmp, path)
    return path


def _make_level_datasets(f, width: int, height: int, num_levels: int, comp: dict):
    cpx = comp.get("chunk_px", 512)
    ds = []
    h, w = height, width
    for lvl in range(num_levels):
        if h < 1 or w < 1:
            break
        ds.append(f.create_dataset(
            f"level_{lvl}", shape=(h, w, 3), dtype="u1", chunks=(min(cpx, h), min(cpx, w), 3),
            compression=comp.get("compression", "gzip"),
            compression_opts=comp.get("compression_opts")))
        h, w = h // 2, w // 2
    return ds


def _write_levels_device(f, width, height, num_levels, tile, seed, blobs, coarse,
                         nuclei_density, comp, device) -> None:
    datasets = _make_level_datasets(f, width, height, num_levels, comp)
    render = _device_band_renderer(width, tile, len(datasets), nuclei_density, device, seed)
    blobs_d = torch.as_tensor(np.asarray(blobs, np.float32), device=device)
    coarse_d = torch.as_tensor(coarse, device=device)
    pending = None      # the next band renders on the card while this one compresses
    for bi, ty in enumerate(range(0, height, tile)):
        outs = render(blobs_d, coarse_d, ty, bi)
        if pending is not None:
            _flush_band(datasets, *pending)
        pending = (tile, ty, [o.cpu().numpy() for o in outs])
    if pending is not None:
        _flush_band(datasets, *pending)


def _flush_band(datasets, tile, ty, host_outs) -> None:
    for lvl, (d, arr) in enumerate(zip(datasets, host_outs)):
        oy = ty >> lvl
        rows = min(arr.shape[0], d.shape[0] - oy)
        if rows > 0:
            d[oy:oy + rows] = arr[:rows]


def _write_levels_numpy(f, width, height, num_levels, tile, seed, blobs, coarse,
                        nuclei_density, comp) -> None:
    datasets = _make_level_datasets(f, width, height, num_levels, comp)
    d0 = datasets[0]
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            h = min(tile, height - ty)
            w = min(tile, width - tx)
            rs_tile = np.random.RandomState(
                (seed * 1000003 + (ty // tile) * 8191 + tx // tile) % (2 ** 31))
            d0[ty:ty + h, tx:tx + w] = _render_tile(tx, ty, w, h, blobs, coarse, rs_tile,
                                                    nuclei_density)
    # the downsampled levels: 2x box means streamed in row bands
    prev = d0
    for lvl in range(1, len(datasets)):
        d = datasets[lvl]
        nh, nw = d.shape[:2]
        for oy in range(0, nh, tile):
            rows = min(tile, nh - oy)
            src = prev[2 * oy:2 * (oy + rows), :2 * nw].astype(np.float32)
            d[oy:oy + rows] = src.reshape(rows, 2, nw, 2, 3).mean(axis=(1, 3)).astype(np.uint8)
        prev = d


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
    device=None,
    timings: Optional[Dict[str, float]] = None,
) -> Path:
    """Stream a synthetic H&E pyramid to a tiled BigTIFF in the Aperio
    layout (256-px tiles, ``AppMag`` in the ImageDescription) with O(band)
    memory. ``compression``: ``"jpeg"`` (through Pillow), ``"deflate"``,
    ``"lzw"`` or ``"raw"``.

    ``device``: the card by default (``None`` / ``"auto"``; raises without
    one), ``"numpy"`` the JAX package's host render (the same bytes), or a
    torch device for the band renderer. The next band renders on the card
    while the host encodes this one; tiles encode in up to 8 threads (the
    bytes are the serial encoder's).
    ``timings``, where given, receives ``render_s`` (rendering, or on a
    device the dispatch and the fetch of each band), ``encode_s`` (encoding
    and writing the tiles) and ``bands``."""
    import os

    from .tiff import StreamingTiledTiffWriter
    path = Path(path)
    div = 1 << (num_levels - 1)
    if width % div or height % band or band % div or width % tiff_tile:
        raise ValueError(
            f"width ({width}) must divide by 2^(levels-1) ({div}) and "
            f"tiff_tile ({tiff_tile}); height ({height}) by band ({band}); "
            f"band by {div}")
    dev = _render_device(device, (width, height, band), num_levels, "band")
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
    clock = {"render_s": 0.0, "encode_s": 0.0, "bands": 0}

    def add(outs, final: bool, pool) -> None:
        t0 = time.perf_counter()
        tt = tiff_tile
        for lvl, arr in enumerate(outs):
            bufs[lvl] = np.concatenate([bufs[lvl], arr], axis=0)
            while bufs[lvl].shape[0] >= tt or (final and bufs[lvl].shape[0]):
                strip, bufs[lvl] = bufs[lvl][:tt], bufs[lvl][tt:]
                writer.write_tiles(lvl, [strip[:, tx:tx + tt]
                                         for tx in range(0, strip.shape[1], tt)], pool)
        clock["encode_s"] += time.perf_counter() - t0
        clock["bands"] += 1

    bands = list(range(0, height, band))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        if dev is None:
            for bi, ty in enumerate(bands):
                t0 = time.perf_counter()
                outs = _render_band_numpy(ty, band, width, num_levels, blobs, coarse,
                                          nuclei_density, seed)
                clock["render_s"] += time.perf_counter() - t0
                add(outs, bi == len(bands) - 1, pool)
        else:
            render = _device_band_renderer(width, band, num_levels, nuclei_density, dev, seed)
            blobs_d = torch.as_tensor(np.asarray(blobs, np.float32), device=dev)
            coarse_d = torch.as_tensor(coarse, device=dev)
            pending = None      # the next band renders on the card while this one encodes
            for bi, ty in enumerate(bands):
                t0 = time.perf_counter()
                outs = render(blobs_d, coarse_d, ty, bi)
                clock["render_s"] += time.perf_counter() - t0
                if pending is not None:
                    add(pending, False, pool)
                t0 = time.perf_counter()
                pending = [o.cpu().numpy() for o in outs]
                clock["render_s"] += time.perf_counter() - t0
            add(pending, True, pool)
    if timings is not None:
        timings.update(clock)
    return writer.close()


def write_synthetic_tiff(
    path: str | Path,
    width: int = 2048,
    height: int = 2048,
    num_levels: int = 4,
    seed: int = 0,
    **image_kw,
) -> Path:
    """A multi-page pyramidal TIFF through Pillow (imported here). Extra
    kwargs (``nuclei_density``, ``num_blobs``, the hard task's
    :func:`sample_hard_slide_params`) pass to :func:`generate_tissue_image`."""
    from PIL import Image
    img, _ = generate_tissue_image(width, height, seed=seed, **image_kw)
    levels = build_pyramid(img, num_levels)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pages = [Image.fromarray(lvl) for lvl in levels]
    pages[0].save(path, save_all=True, append_images=pages[1:], format="TIFF")
    return path
