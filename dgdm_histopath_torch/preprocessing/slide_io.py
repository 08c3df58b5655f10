"""Pyramidal whole-slide reading behind one backend interface with
OpenSlide's coordinate semantics (``read_region`` at level-0 coordinates).

Counterpart of the JAX package's ``preprocessing/slide_io.py``:

  * ``OpenSlideBackend``: .svs/.ndpi/.mrxs through openslide, where it is
    installed;
  * ``TiledTiffBackend``: tiled (Big)TIFF through ``tiff.py`` (numpy);
  * ``PILTiffBackend``: multi-page TIFF through Pillow, where installed;
  * ``HDF5SlideBackend``: dgdm_wsi chunked-HDF5 slides (``.h5``, ``.hdf5``,
    ``.wsi``), through the native chunk reader (``native/``) or h5py;
  * ``ArrayBackend``: an in-memory numpy pyramid.

h5py is imported only where an HDF5 slide is opened or written.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..utils.exceptions import SlideProcessingError

try:
    import openslide  # type: ignore
    OPENSLIDE_AVAILABLE = True
except ImportError:
    OPENSLIDE_AVAILABLE = False


def _advise_readahead(path) -> None:
    """Kick off whole-file kernel readahead (POSIX_FADV_WILLNEED).

    Slide access is a raster of small random chunk reads; on a cold page
    cache those serialize at seek latency. WILLNEED is asynchronous and
    advisory — the kernel streams the file at sequential bandwidth in the
    background while the reader's random reads hit already-cached pages."""
    import os
    try:
        fd = os.open(str(path), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
        finally:
            os.close(fd)
    except (AttributeError, OSError):
        pass


class SlideBackend:
    """Common pyramid-reader interface (OpenSlide coordinate semantics)."""

    level_count: int
    level_dimensions: List[Tuple[int, int]]   # [(w, h)] per level
    level_downsamples: List[float]
    properties: Dict[str, str]

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """location in LEVEL-0 coords; returns [h, w, 3] uint8 RGB."""
        raise NotImplementedError

    def best_level_for_downsample(self, downsample: float) -> int:
        """Largest level whose downsample <= requested (OpenSlide semantics)."""
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 0.01:
                best = i
        return best

    def get_thumbnail(self, max_size: int = 1024) -> np.ndarray:
        level = self.level_count - 1
        w, h = self.level_dimensions[level]
        img = self.read_region((0, 0), level, (w, h))
        scale = max(w, h) / max_size
        if scale > 1.0:
            step = int(np.ceil(scale))
            img = img[::step, ::step]
        return img

    def clone(self) -> Optional["SlideBackend"]:
        """An independent handle for thread-parallel decode, or None when the
        backend can't provide one (stateful readers like PIL page seeks)."""
        return None

    def read_regions(self, locations: Sequence[Tuple[int, int]], level: int,
                     size: Tuple[int, int]) -> np.ndarray:
        """Batch region read -> [len(locations), h, w, 3] uint8. Default:
        per-region loop; chunked backends override with banded reads."""
        return np.stack([self.read_region(loc, level, size)
                         for loc in locations])

    def advise_regions(self, locations: Sequence[Tuple[int, int]],
                       level: int, size: Tuple[int, int]) -> None:
        """Asynchronously hint the kernel to stream the bytes a FUTURE
        ``read_regions(locations, ...)`` will touch (advisory, no reads).
        The decode pipeline calls this one batch ahead so cold disk
        transfer overlaps the current batch's decompression. Default:
        no-op (whole-file readahead at open already covers non-chunked
        backends)."""

    def prefetch(self) -> None:
        """Hint the kernel to stream this slide's file into the page cache
        (asynchronous, advisory). Called by ``predict_slides`` when a slide
        is opened one-ahead so cold disk reads overlap the previous slide's
        device time. Default: whole-file WILLNEED on the backing path."""
        path = getattr(self, "_path", None)
        if path:
            _advise_readahead(path)

    def close(self) -> None:
        pass


class OpenSlideBackend(SlideBackend):
    def __init__(self, path: str | Path):
        if not OPENSLIDE_AVAILABLE:
            raise SlideProcessingError("openslide is not installed", {"path": str(path)})
        self._path = str(path)
        self._slide = openslide.OpenSlide(str(path))
        self.level_count = self._slide.level_count
        self.level_dimensions = [tuple(d) for d in self._slide.level_dimensions]
        self.level_downsamples = [float(d) for d in self._slide.level_downsamples]
        self.properties = dict(self._slide.properties)

    def read_region(self, location, level, size):
        img = self._slide.read_region(location, level, size).convert("RGB")
        return np.asarray(img, np.uint8)

    def clone(self):
        return OpenSlideBackend(self._path)

    def close(self):
        self._slide.close()


class PILTiffBackend(SlideBackend):
    """Multi-page TIFF pyramid via Pillow (pages sorted by size desc)."""

    def __init__(self, path: str | Path):
        from PIL import Image
        Image.MAX_IMAGE_PIXELS = None
        self._path = str(path)
        self._img = Image.open(self._path)
        dims = []
        i = 0
        while True:
            try:
                self._img.seek(i)
            except EOFError:
                break
            dims.append((i, self._img.size))  # (page, (w, h))
            i += 1
        if not dims:
            raise SlideProcessingError("TIFF has no pages", {"path": self._path})
        dims.sort(key=lambda t: -t[1][0] * t[1][1])
        self._pages = [p for p, _ in dims]
        self.level_dimensions = [s for _, s in dims]
        self.level_count = len(dims)
        w0, h0 = self.level_dimensions[0]
        self.level_downsamples = [w0 / w for (w, h) in self.level_dimensions]
        self.properties = {str(k): str(v) for k, v in (self._img.tag_v2 or {}).items()} \
            if hasattr(self._img, "tag_v2") else {}
        self._cache: Dict[int, np.ndarray] = {}

    def _level_array(self, level: int) -> np.ndarray:
        if level not in self._cache:
            self._img.seek(self._pages[level])
            self._cache[level] = np.asarray(self._img.convert("RGB"), np.uint8)
        return self._cache[level]

    def read_region(self, location, level, size):
        arr = self._level_array(level)
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = size
        out = np.full((h, w, 3), 255, np.uint8)
        y1 = min(y0 + h, arr.shape[0])
        x1 = min(x0 + w, arr.shape[1])
        if y1 > y0 and x1 > x0 and y0 >= 0 and x0 >= 0:
            out[: y1 - y0, : x1 - x0] = arr[y0:y1, x0:x1]
        return out

    def close(self):
        self._img.close()
        self._cache.clear()


class TiledTiffBackend(SlideBackend):
    """Windowed tiled/pyramidal (Big)TIFF reader — the container of most
    Aperio .svs files — with no OpenSlide/tifffile dependency.

    Decodes only the tiles a region touches (LRU tile cache), so gigapixel
    level-0 pages never materialize; parses Aperio ImageDescription
    metadata (AppMag/MPP) into OpenSlide-style properties. Reference
    surface: ``preprocessing/slide_processor.py:116-146`` (OpenSlide decode).
    See ``preprocessing/tiff.py`` for the format support matrix.
    """

    def __init__(self, path: str | Path):
        from .tiff import TiffFormatError, TiledTiffReader
        try:
            self._reader = TiledTiffReader(path)
        except TiffFormatError as exc:
            raise SlideProcessingError(str(exc), {"path": str(path)}) from exc
        self._path = str(path)
        self.level_dimensions = self._reader.level_dimensions
        self.level_count = len(self.level_dimensions)
        w0 = self.level_dimensions[0][0]
        self.level_downsamples = [w0 / w for (w, h) in self.level_dimensions]
        self.properties = dict(self._reader.properties)

    def read_region(self, location, level, size):
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = size
        return self._reader.read_region_level(level, x0, y0, w, h)

    def clone(self):
        # independent file handle + tile cache: thread-parallel decode works
        return TiledTiffBackend(self._path)

    def close(self):
        self._reader.close()


class HDF5SlideBackend(SlideBackend):
    """A dgdm_wsi chunked-HDF5 pyramidal slide: datasets ``level_0`` ..
    ``level_{L-1}`` of [H, W, 3] uint8 in tile-sized chunks,
    ``attrs["dgdm_wsi"] = "1"``, and the OpenSlide-style properties as JSON
    in ``attrs["properties"]`` (written by :func:`write_hdf5_slide` and
    ``synthetic.write_synthetic_slide_hdf5``; the JAX package's format).

    Where ``native.enabled()`` at opening (``DGDM_NATIVE_IO`` not ``"0"``),
    every level the native reader can take (``native.ChunkIndex.from_dataset``)
    reads through it, and the library is built here if it is missing; any
    other level, and every level under ``DGDM_NATIVE_IO=0``, reads through
    h5py. A failed build or native read raises. As in the JAX package, the
    h5py ``read_region`` fills the whole patch with 255 when the origin is
    negative, where the native reader and both ``read_regions`` keep the
    part inside the level.
    """

    MAGIC = "dgdm_wsi"

    def __init__(self, path: str | Path):
        import h5py
        self._path = str(path)
        self._native = native.enabled()
        if self._native:
            native.get_lib()
        else:
            # the h5py reader alone: stream the whole file behind the random
            # reads (the native reader advises exactly each batch's chunks)
            _advise_readahead(path)
        self._chunk_index: Dict[int, Optional[native.ChunkIndex]] = {}
        # raster-order patch reads revisit chunks: a cache that holds a row
        # of decompressed chunks (h5py's default 1 MB thrashes)
        self._f = h5py.File(self._path, "r", rdcc_nbytes=128 * 2 ** 20, rdcc_nslots=100003)
        if self.MAGIC not in self._f.attrs:
            self._f.close()
            raise SlideProcessingError("not a dgdm_wsi HDF5 slide", {"path": self._path})
        self._levels = []
        while f"level_{len(self._levels)}" in self._f:
            self._levels.append(self._f[f"level_{len(self._levels)}"])
        if not self._levels:
            self._f.close()
            raise SlideProcessingError("HDF5 slide has no levels", {"path": self._path})
        self.level_count = len(self._levels)
        self.level_dimensions = [(d.shape[1], d.shape[0]) for d in self._levels]
        w0 = self.level_dimensions[0][0]
        self.level_downsamples = [w0 / w for (w, h) in self.level_dimensions]
        self.properties = json.loads(self._f.attrs.get("properties", "{}"))

    def _native_index(self, level: int) -> Optional["native.ChunkIndex"]:
        """The level's chunk index, built once; None under the h5py reader
        or for a dataset the native reader does not take."""
        if not self._native:
            return None
        if level not in self._chunk_index:
            self._chunk_index[level] = native.ChunkIndex.from_dataset(self._levels[level])
        return self._chunk_index[level]

    def read_region(self, location, level, size):
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = size
        idx = self._native_index(level)
        if idx is not None:
            native.count_read("native")
            return idx.read_patches(self._path, [y0], [x0], h, w)[0]
        native.count_read("h5py")
        arr = self._levels[level]
        out = np.full((h, w, 3), 255, np.uint8)
        y1 = min(y0 + h, arr.shape[0])
        x1 = min(x0 + w, arr.shape[1])
        if y1 > y0 and x1 > x0 and y0 >= 0 and x0 >= 0:
            out[: y1 - y0, : x1 - x0] = arr[y0:y1, x0:x1]     # chunked read
        return out

    def clone(self):
        # h5py serializes every HDF5 call behind one lock, so handles do not
        # decode in parallel through it; the banded reads are what helps
        return HDF5SlideBackend(self._path)

    def read_regions(self, locations, level, size):
        """Batch read. Native: the whole batch in one C call (chunk-major
        pread + inflate + assembly). h5py: patches sharing a row are cut
        from one strip read, split where the gap exceeds 2 patch widths, so
        that each chunk decompresses once instead of once per patch."""
        ds = self.level_downsamples[level]
        w, h = size
        idx = self._native_index(level)
        if idx is not None:
            native.count_read("native")
            ys = [int(loc[1] / ds) for loc in locations]
            xs = [int(loc[0] / ds) for loc in locations]
            return idx.read_patches(self._path, ys, xs, h, w)
        native.count_read("h5py")
        arr = self._levels[level]
        n = len(locations)
        out = np.full((n, h, w, 3), 255, np.uint8)
        order = sorted(range(n), key=lambda i: (int(locations[i][1] / ds),
                                                int(locations[i][0] / ds)))
        i = 0
        while i < n:
            y0 = int(locations[order[i]][1] / ds)
            row = [order[i]]
            i += 1
            while i < n and int(locations[order[i]][1] / ds) == y0:
                row.append(order[i])
                i += 1
            y_lo, y_hi = max(y0, 0), min(y0 + h, arr.shape[0])
            if y_hi <= y_lo:
                continue
            pairs = sorted(zip((int(locations[j][0] / ds) for j in row), row))
            segments: list = [[pairs[0]]]
            for x0, j in pairs[1:]:
                if x0 - segments[-1][-1][0] > 2 * w:
                    segments.append([])
                segments[-1].append((x0, j))
            for seg in segments:
                x_lo, x_hi = max(seg[0][0], 0), min(seg[-1][0] + w, arr.shape[1])
                if x_hi <= x_lo:
                    continue
                strip = arr[y_lo:y_hi, x_lo:x_hi]           # one chunked read
                for x0, j in seg:
                    sx0, sx1 = max(x0, 0) - x_lo, min(x0 + w, x_hi) - x_lo
                    if sx1 <= sx0:
                        continue
                    oy, ox = y_lo - y0, max(x0, 0) - x0
                    out[j, oy:oy + (y_hi - y_lo), ox:ox + (sx1 - sx0)] = strip[:, sx0:sx1]
        return out

    def advise_regions(self, locations, level, size):
        """WILLNEED on the chunk byte ranges a later ``read_regions`` of
        these locations touches (native reader only)."""
        idx = self._native_index(level)
        if idx is None or not locations:
            return
        ds = self.level_downsamples[level]
        w, h = size
        idx.advise_patches(self._path, [int(loc[1] / ds) for loc in locations],
                           [int(loc[0] / ds) for loc in locations], h, w)

    def close(self):
        self._f.close()


def write_hdf5_slide(path: str | Path, levels: Sequence[np.ndarray],
                     properties: Optional[Dict[str, str]] = None, tile: int = 1024,
                     compression: Optional[str] = "gzip", compression_opts: int = 2) -> Path:
    """Write an in-memory pyramid as a dgdm_wsi HDF5 slide (chunks of
    ``tile``², clipped to each level). For gigapixel sizes use the streaming
    writer, ``synthetic.write_synthetic_slide_hdf5``."""
    import h5py
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs[HDF5SlideBackend.MAGIC] = "1"
        f.attrs["properties"] = json.dumps(dict(properties or {}))
        for i, lvl in enumerate(levels):
            lvl = np.asarray(lvl, np.uint8)
            f.create_dataset(f"level_{i}", data=lvl,
                             chunks=(min(tile, lvl.shape[0]), min(tile, lvl.shape[1]), 3),
                             compression=compression,
                             compression_opts=compression_opts if compression == "gzip" else None)
    return path


class ArrayBackend(SlideBackend):
    """In-memory numpy pyramid: levels[0] is full resolution [H, W, 3]."""

    def __init__(self, levels: Sequence[np.ndarray],
                 properties: Optional[Dict[str, str]] = None):
        self._levels = [np.asarray(lvl, np.uint8) for lvl in levels]
        self.level_count = len(self._levels)
        self.level_dimensions = [(a.shape[1], a.shape[0]) for a in self._levels]
        w0 = self.level_dimensions[0][0]
        self.level_downsamples = [w0 / w for (w, h) in self.level_dimensions]
        self.properties = dict(properties or {})

    def read_region(self, location, level, size):
        arr = self._levels[level]
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = size
        out = np.full((h, w, 3), 255, np.uint8)
        y1 = min(y0 + h, arr.shape[0])
        x1 = min(x0 + w, arr.shape[1])
        if y1 > y0 and x1 > x0 and y0 >= 0 and x0 >= 0:
            out[: y1 - y0, : x1 - x0] = arr[y0:y1, x0:x1]
        return out

    def clone(self):
        return self    # pure numpy slicing — already thread-safe


def open_slide(source) -> SlideBackend:
    """Open a slide from a path, or pass a backend through."""
    if isinstance(source, SlideBackend):
        return source
    path = Path(source)
    if not path.exists():
        raise SlideProcessingError("slide file not found", {"path": str(path)})
    suffix = path.suffix.lower()
    if suffix in (".h5", ".hdf5", ".wsi"):
        return HDF5SlideBackend(path)
    if suffix in (".svs", ".tif", ".tiff", ".ndpi"):
        if OPENSLIDE_AVAILABLE:
            try:
                return OpenSlideBackend(path)
            except Exception:  # noqa: BLE001 - a format openslide refuses: the readers below
                pass
        # most .svs/.ndpi are tiled (Big)TIFF underneath
        try:
            return TiledTiffBackend(path)
        except SlideProcessingError:
            pass
        if suffix in (".tif", ".tiff"):
            return PILTiffBackend(path)
        raise SlideProcessingError(
            "cannot decode slide (unsupported TIFF layout and OpenSlide "
            "unavailable)", {"path": str(path)})
    if OPENSLIDE_AVAILABLE:
        return OpenSlideBackend(path)
    raise SlideProcessingError(
        "no backend available for slide format", {"path": str(path), "suffix": suffix})
