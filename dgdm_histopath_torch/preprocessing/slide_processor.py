"""SlideProcessor: pyramid decode -> tissue mask -> patch grid -> patches.

Counterpart of the JAX package's ``preprocessing/slide_processor.py``:
metadata with the objective power (``openslide.objective-power`` or
``aperio.AppMag``, 40x by default), the tissue mask of a thumbnail, the
patch grid per magnification gated on tissue fraction (an integral image of
the mask; strides in level-0 coordinates), pyramid level matching, batched
region decode (``read_regions``), a process pool for decode of path-backed
slides, optional stain normalization of the decoded patches on the device,
and ``process_slide`` with uniform subsampling to ``max_patches``.

The tissue mask and stain normalization run on ``device`` (``None`` means
``"cuda"``); decode runs on the host. Decode workers never touch the card.
``save_slide_data`` / ``load_slide_data`` write and read the JAX package's
``.h5`` slide-data files (h5py, imported there).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.exceptions import SlideProcessingError
from .slide_io import SlideBackend, open_slide
from .stain_normalization import StainNormalizer
from .tissue_detection import TissueDetector

logger = logging.getLogger(__name__)


@dataclass
class PatchInfo:
    """One extracted patch."""
    x: int                  # level-0 x
    y: int                  # level-0 y
    level: int
    magnification: float
    size: int
    tissue_fraction: float


# the ``patch_info`` records of a slide-data file
PATCH_INFO_DTYPE = [("x", "i8"), ("y", "i8"), ("level", "i4"), ("magnification", "f4"),
                    ("size", "i4"), ("tissue_fraction", "f4")]


@dataclass
class SlideData:
    """A processed slide: its patches, their grid records and metadata."""
    slide_id: str
    slide_path: str
    patches: np.ndarray               # [P, S, S, 3] uint8
    patch_info: List[PatchInfo]
    metadata: Dict
    tissue_mask: Optional[np.ndarray] = None

    @property
    def num_patches(self) -> int:
        return len(self.patch_info)


def _integral_image(mask: np.ndarray) -> np.ndarray:
    ii = np.zeros((mask.shape[0] + 1, mask.shape[1] + 1), np.int64)
    ii[1:, 1:] = np.cumsum(np.cumsum(mask.astype(np.int64), axis=0), axis=1)
    return ii


def _box_sum(ii: np.ndarray, y0, x0, y1, x1) -> np.ndarray:
    """Vectorized box sums over an integral image (half-open [y0,y1)×[x0,x1))."""
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


class SlideProcessor:
    """End-to-end slide→patches pipeline."""

    def __init__(
        self,
        patch_size: int = 256,
        overlap: int = 0,
        tissue_threshold: float = 0.8,
        max_patches: Optional[int] = 1000,
        magnifications: Sequence[float] = (20.0,),
        stain_normalize: bool = True,
        stain_method: str = "macenko",
        tissue_detector: Optional[TissueDetector] = None,
        thumbnail_size: int = 1024,
        stain_batch_size: int = 256,
        device=None,
    ):
        if patch_size <= 0:
            raise SlideProcessingError("patch_size must be positive")
        if not 0.0 <= tissue_threshold <= 1.0:
            raise SlideProcessingError("tissue_threshold must be in [0, 1]")
        self.patch_size = patch_size
        self.overlap = overlap
        self.tissue_threshold = tissue_threshold
        self.max_patches = max_patches
        self.magnifications = list(magnifications)
        self.stain_normalizer = (StainNormalizer(stain_method, device=device)
                                 if stain_normalize else None)
        self.tissue_detector = tissue_detector or TissueDetector(device=device)
        self.thumbnail_size = thumbnail_size
        self.stain_batch_size = stain_batch_size

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------
    @staticmethod
    def get_objective_power(slide: SlideBackend) -> float:
        """Native objective power; 40x where the slide does not say."""
        props = slide.properties
        for key in ("openslide.objective-power", "aperio.AppMag", "objective-power"):
            if key in props:
                try:
                    return float(props[key])
                except ValueError:
                    continue
        return 40.0

    def get_metadata(self, slide: SlideBackend, path: str = "") -> Dict:
        return {
            "path": str(path),
            "dimensions": list(slide.dimensions),
            "level_count": slide.level_count,
            "level_dimensions": [list(d) for d in slide.level_dimensions],
            "level_downsamples": list(slide.level_downsamples),
            "objective_power": self.get_objective_power(slide),
            "patch_size": self.patch_size,
            "magnifications": self.magnifications,
        }

    # ------------------------------------------------------------------
    # tissue mask
    # ------------------------------------------------------------------
    def get_thumbnail(self, slide: SlideBackend) -> np.ndarray:
        return slide.get_thumbnail(self.thumbnail_size)

    def detect_tissue_regions(self, slide: SlideBackend) -> Tuple[np.ndarray, float]:
        """Tissue mask at thumbnail resolution + its level-0 downsample."""
        thumb = self.get_thumbnail(slide)
        mask = self.tissue_detector.detect_tissue(thumb)
        downsample = slide.dimensions[0] / mask.shape[1]
        return mask, downsample

    # ------------------------------------------------------------------
    # patch grid
    # ------------------------------------------------------------------
    def level_for_magnification(self, slide: SlideBackend, magnification: float
                                ) -> Tuple[int, float]:
        """Best pyramid level for a target magnification
        Returns (level, effective_downsample_from_L0)."""
        native = self.get_objective_power(slide)
        want_ds = native / magnification
        level = slide.best_level_for_downsample(want_ds)
        return level, want_ds

    def generate_patch_coordinates(
        self,
        slide: SlideBackend,
        tissue_mask: np.ndarray,
        mask_downsample: float,
    ) -> List[PatchInfo]:
        """Grid candidates per magnification, gated on tissue fraction.

        All strides are in level-0 space: a patch of
        ``patch_size`` pixels at magnification m covers
        ``patch_size * native/m`` level-0 pixels.
        """
        w0, h0 = slide.dimensions
        native = self.get_objective_power(slide)
        ii = _integral_image(tissue_mask)
        mh, mw = tissue_mask.shape
        out: List[PatchInfo] = []
        for mag in self.magnifications:
            level, want_ds = self.level_for_magnification(slide, mag)
            span0 = int(round(self.patch_size * native / mag))     # level-0 extent
            stride0 = max(1, span0 - int(round(self.overlap * native / mag)))
            xs = np.arange(0, max(w0 - span0 + 1, 1), stride0, dtype=np.int64)
            ys = np.arange(0, max(h0 - span0 + 1, 1), stride0, dtype=np.int64)
            if len(xs) == 0 or len(ys) == 0:
                continue
            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            gx, gy = gx.ravel(), gy.ravel()
            # tissue fraction via integral image at mask resolution
            mx0 = np.clip((gx / mask_downsample).astype(np.int64), 0, mw)
            my0 = np.clip((gy / mask_downsample).astype(np.int64), 0, mh)
            mx1 = np.clip(((gx + span0) / mask_downsample).astype(np.int64), 0, mw)
            my1 = np.clip(((gy + span0) / mask_downsample).astype(np.int64), 0, mh)
            area = np.maximum((mx1 - mx0) * (my1 - my0), 1)
            frac = _box_sum(ii, my0, mx0, my1, mx1) / area
            keep = frac >= self.tissue_threshold
            for x, y, f in zip(gx[keep], gy[keep], frac[keep]):
                out.append(PatchInfo(int(x), int(y), level, mag,
                                     self.patch_size, float(f)))
        return out

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------
    def extract_patch(self, slide: SlideBackend, info: PatchInfo) -> np.ndarray:
        """Read one patch at its magnification (host decode)."""
        native = self.get_objective_power(slide)
        level_ds = slide.level_downsamples[info.level]
        want_ds = native / info.magnification
        read_size = int(round(info.size * want_ds / level_ds))
        img = slide.read_region((info.x, info.y), info.level, (read_size, read_size))
        if read_size != info.size:
            img = _resize_uint8(img, info.size)
        return img

    def extract_patch_batch(self, slide: SlideBackend,
                            infos: Sequence[PatchInfo]) -> np.ndarray:
        """Decode a batch of patches via the backend's batched ``read_regions``
        (banded reads on chunked backends — each compressed chunk is
        decompressed once per batch instead of once per patch)."""
        if not infos:
            return np.zeros((0, self.patch_size, self.patch_size, 3), np.uint8)
        native = self.get_objective_power(slide)
        groups: Dict[Tuple[int, int], list] = {}
        for i, info in enumerate(infos):
            level_ds = slide.level_downsamples[info.level]
            want_ds = native / info.magnification
            read_size = int(round(info.size * want_ds / level_ds))
            groups.setdefault((info.level, read_size), []).append(i)
        out = np.zeros((len(infos), self.patch_size, self.patch_size, 3),
                       np.uint8)
        for (level, read_size), idxs in groups.items():
            locs = [(infos[i].x, infos[i].y) for i in idxs]
            imgs = slide.read_regions(locs, level, (read_size, read_size))
            for img, i in zip(imgs, idxs):
                if read_size != infos[i].size:
                    img = _resize_uint8(img, infos[i].size)
                out[i] = img
        return out

    def advise_patch_batch(self, slide: SlideBackend,
                           infos: Sequence[PatchInfo]) -> None:
        """Advisory readahead for a FUTURE ``extract_patch_batch(infos)``:
        group by (level, read_size) exactly like the extractor and hand
        each group to the backend's ``advise_regions``. Called one batch
        ahead by the decode pipeline — overlaps cold disk transfer with the
        current batch's decompression. Never raises."""
        if not infos:
            return
        try:
            native = self.get_objective_power(slide)
            groups: Dict[Tuple[int, int], list] = {}
            for info in infos:
                level_ds = slide.level_downsamples[info.level]
                want_ds = native / info.magnification
                read_size = int(round(info.size * want_ds / level_ds))
                groups.setdefault((info.level, read_size), []).append(
                    (info.x, info.y))
            for (level, read_size), locs in groups.items():
                slide.advise_regions(locs, level, (read_size, read_size))
        except Exception:  # noqa: BLE001 - purely advisory
            pass

    def extract_patch_batch_parallel(self, slide: SlideBackend,
                                     infos: Sequence[PatchInfo],
                                     pool, workers: int) -> np.ndarray:
        """Process-parallel banded decode for path-backed slides.

        Inflating compressed tiles is CPU-bound and holds the interpreter
        lock in places, so decode is spread over processes: each worker
        opens its own backend handle (by path) and decodes a contiguous run
        of the batch, which keeps its reads local.
        """
        path = getattr(slide, "_path", None)
        if path is None or workers <= 1 or len(infos) < workers * 2:
            return self.extract_patch_batch(slide, infos)
        try:
            runs = np.array_split(np.arange(len(infos)), workers)
            futures = []
            for run in runs:
                if len(run) == 0:
                    continue
                sub = [infos[i] for i in run]
                futures.append((run, pool.submit(
                    _decode_patches_worker, path, self.patch_size,
                    [(p.x, p.y, p.level, p.magnification, p.size)
                     for p in sub])))
            out = np.zeros((len(infos), self.patch_size, self.patch_size, 3),
                           np.uint8)
            for run, fut in futures:
                out[run] = fut.result()
            return out
        except Exception as exc:  # noqa: BLE001 - broken pool, pickling, OOM
            logger.warning("parallel decode failed (%s); falling back to "
                           "in-process decode", exc)
            return self.extract_patch_batch(slide, infos)

    def extract_patches(self, slide: SlideBackend,
                        infos: Sequence[PatchInfo]) -> np.ndarray:
        """Decode all patches (host) then stain-normalize in device batches."""
        if not infos:
            return np.zeros((0, self.patch_size, self.patch_size, 3), np.uint8)
        patches = self.extract_patch_batch(slide, infos)
        if self.stain_normalizer is not None:
            bs = self.stain_batch_size
            chunks = [self.stain_normalizer.normalize(patches[i:i + bs])
                      for i in range(0, len(patches), bs)]
            patches = np.concatenate(chunks, axis=0)
        return patches

    # ------------------------------------------------------------------
    # orchestration
    # ------------------------------------------------------------------
    def process_slide(self, source, slide_id: Optional[str] = None) -> SlideData:
        """Mask, patch grid, subsample to ``max_patches``, decode (and
        stain-normalize) every patch."""
        slide = open_slide(source)
        try:
            path = str(source) if not isinstance(source, SlideBackend) else ""
            sid = slide_id or (Path(path).stem if path else "slide")
            metadata = self.get_metadata(slide, path)
            mask, mask_ds = self.detect_tissue_regions(slide)
            infos = self.generate_patch_coordinates(slide, mask, mask_ds)
            if not infos:
                logger.warning("slide %s: no tissue patches found", sid)
            if self.max_patches is not None and len(infos) > self.max_patches:
                # uniform subsample
                idx = np.linspace(0, len(infos) - 1, self.max_patches).astype(int)
                infos = [infos[i] for i in idx]
            patches = self.extract_patches(slide, infos)
            metadata["num_patches"] = len(infos)
            metadata["tissue_fraction"] = float(mask.mean()) if mask.size else 0.0
            return SlideData(slide_id=sid, slide_path=path, patches=patches,
                             patch_info=infos, metadata=metadata,
                             tissue_mask=mask)
        finally:
            slide.close()

    # ------------------------------------------------------------------
    # HDF5 persistence
    # ------------------------------------------------------------------
    @staticmethod
    def save_slide_data(data: SlideData, path: str | Path) -> Path:
        """``patches`` (gzip 4), ``tissue_mask`` (uint8, where there is one),
        ``patch_info`` (a structured array) and the attributes ``slide_id``,
        ``slide_path`` and ``metadata`` (JSON): the JAX package's layout."""
        import h5py
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("patches", data=data.patches, compression="gzip",
                             compression_opts=4)
            if data.tissue_mask is not None:
                f.create_dataset("tissue_mask", data=data.tissue_mask.astype(np.uint8))
            f.create_dataset("patch_info", data=np.array(
                [(p.x, p.y, p.level, p.magnification, p.size, p.tissue_fraction)
                 for p in data.patch_info], dtype=PATCH_INFO_DTYPE))
            f.attrs["slide_id"] = data.slide_id
            f.attrs["slide_path"] = data.slide_path
            f.attrs["metadata"] = json.dumps(data.metadata)
        return path

    @staticmethod
    def load_slide_data(path: str | Path) -> SlideData:
        import h5py
        with h5py.File(path, "r") as f:
            mask = f["tissue_mask"][:].astype(bool) if "tissue_mask" in f else None
            infos = [PatchInfo(int(r["x"]), int(r["y"]), int(r["level"]),
                               float(r["magnification"]), int(r["size"]),
                               float(r["tissue_fraction"])) for r in f["patch_info"][:]]
            return SlideData(slide_id=str(f.attrs["slide_id"]),
                             slide_path=str(f.attrs["slide_path"]),
                             patches=f["patches"][:], patch_info=infos,
                             metadata=json.loads(str(f.attrs["metadata"])), tissue_mask=mask)


def _resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Area/bilinear resize to size×size (PIL on host)."""
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR),
                      np.uint8)


# per-worker backend cache for process-parallel decode
_WORKER_SLIDES: Dict[str, SlideBackend] = {}


def _decode_worker_init():
    """Spawn-worker initializer: hide every CUDA device from the worker.

    Decode is numpy; importing the package imports torch but initialises no
    CUDA context, and with no visible device nothing in the worker can.
    """
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _decode_patches_worker(path: str, patch_size: int, coords) -> np.ndarray:
    """Decode a run of patches in a worker process (own backend handle)."""
    from .slide_io import open_slide
    slide = _WORKER_SLIDES.get(path)
    if slide is None:
        slide = open_slide(path)
        _WORKER_SLIDES[path] = slide
        if len(_WORKER_SLIDES) > 4:          # bound open handles
            old = next(iter(_WORKER_SLIDES))
            if old != path:
                _WORKER_SLIDES.pop(old).close()
    infos = [PatchInfo(x, y, level, mag, size, 0.0)
             for (x, y, level, mag, size) in coords]
    native = SlideProcessor.get_objective_power(slide)
    groups: Dict[Tuple[int, int], list] = {}
    for i, info in enumerate(infos):
        level_ds = slide.level_downsamples[info.level]
        want_ds = native / info.magnification
        read_size = int(round(info.size * want_ds / level_ds))
        groups.setdefault((info.level, read_size), []).append(i)
    out = np.zeros((len(infos), patch_size, patch_size, 3), np.uint8)
    for (level, read_size), idxs in groups.items():
        locs = [(infos[i].x, infos[i].y) for i in idxs]
        imgs = slide.read_regions(locs, level, (read_size, read_size))
        for img, i in zip(imgs, idxs):
            if read_size != infos[i].size:
                img = _resize_uint8(img, infos[i].size)
            out[i] = img
    return out
