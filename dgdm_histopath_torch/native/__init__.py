"""The native chunk reader for dgdm_wsi HDF5 slides, loaded with ctypes.

``dgdm_io.cpp`` (a copy of the JAX package's reader) reads chunked [H, W, 3]
uint8 HDF5 datasets by pread(2) straight from the HDF5 chunk index, inflates
gzip / LZF chunks, assembles patch windows, keeps a decoded-chunk cache for
compressed datasets and issues targeted WILLNEED advice. It is host IO.

The library is built with g++ at first use into ``dgdm_histopath_torch/
build/libdgdm_io-<hash>.so``, where the hash covers the source and the flags
(as ``ops/kernels/build.py`` names the CUDA libraries). Each build compiles
to a name of its own (pid and a random suffix) and is renamed into place, so
processes that build at once never write one file. A failed build or a
failed native read raises with the compiler's or the reader's message; no
reader falls back to another quietly. ``DGDM_NATIVE_IO=0`` asks for the h5py
reader instead (:func:`enabled`).

:func:`reader_counts` counts which reader served each region read
(``"native"`` or ``"h5py"``), as the kernel wrappers count launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import secrets
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dgdm_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-pthread")
ABI_VERSION = 3

#: compression codes understood by the native reader (as in dgdm_io.cpp)
COMP_RAW, COMP_GZIP, COMP_LZF = 0, 1, 2

_ERRORS = {-1: "open failed", -2: "pread failed", -3: "chunk decompression failed",
           -4: "bad arguments"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_counts = {"native": 0, "h5py": 0}
_count_lock = threading.Lock()


def enabled() -> bool:
    """Whether HDF5 slides read through the native reader (``DGDM_NATIVE_IO``
    other than ``"0"``), read at each backend's opening."""
    return os.environ.get("DGDM_NATIVE_IO", "1") != "0"


def count_read(reader: str) -> None:
    with _count_lock:
        _counts[reader] += 1


def reader_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_counts)


def reset_reader_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libdgdm_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library for the current source and flags, compiled if missing.
    Raises RuntimeError with g++'s message when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}-{secrets.token_hex(4)}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"building the native chunk reader failed: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native chunk reader failed ({' '.join(cmd)}):\n"
                           f"{res.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    i64, u64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    read_args = [ctypes.c_char_p, i64, i64, i64, i64,      # path, lvl_h, lvl_w, ch, cw
                 u64p, u64p, ctypes.POINTER(ctypes.c_uint32),   # offsets, nbytes, fmask
                 ctypes.c_int, i64, i64p, i64p, i64, i64,   # comp, n, ys, xs, ph, pw
                 ctypes.POINTER(ctypes.c_uint8),            # out
                 ctypes.c_int, ctypes.c_int]                # nthreads, do_readahead
    lib.dgdm_read_patches.restype = ctypes.c_int
    lib.dgdm_read_patches.argtypes = read_args
    lib.dgdm_read_patches_cached.restype = ctypes.c_int
    lib.dgdm_read_patches_cached.argtypes = read_args + [ctypes.c_void_p]
    lib.dgdm_cache_new.restype = ctypes.c_void_p
    lib.dgdm_cache_new.argtypes = [i64]
    lib.dgdm_cache_free.restype = None
    lib.dgdm_cache_free.argtypes = [ctypes.c_void_p]
    lib.dgdm_cache_stats.restype = None
    lib.dgdm_cache_stats.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
    lib.dgdm_advise_patches.restype = ctypes.c_int
    lib.dgdm_advise_patches.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, u64p, u64p,
                                        i64, i64p, i64p, i64, i64]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises when it cannot be built
    or loaded, or its ABI is not this loader's."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            if lib.dgdm_io_version() != ABI_VERSION:
                raise RuntimeError(f"native chunk reader ABI {lib.dgdm_io_version()}, "
                                   f"expected {ABI_VERSION}")
            _bind(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native reader can serve reads here: the library builds
    and loads (on first use). A read through it still raises on a failure."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class ChunkIndex:
    """Chunk addresses of one chunked [H, W, 3] uint8 HDF5 dataset,
    enumerated once through h5py and handed to the native reader thereafter.

    Raw, gzip and LZF chunks are read; a dataset of another dtype or rank,
    contiguous, of another channel count or chunking across channels, or
    with shuffle, fletcher32 or scale-offset is not eligible
    (:meth:`from_dataset` returns None, and the backend reads it with h5py).
    """

    __slots__ = ("lvl_h", "lvl_w", "ch", "cw", "comp", "offsets", "nbytes", "fmask", "_cache")

    #: decoded-chunk cache budget for compressed datasets (consecutive patch
    #: batches re-touch chunk columns); 0 disables it. Raw datasets never
    #: cache: a hit would only replace a page-cache pread with a memcpy.
    CACHE_MB_DEFAULT = int(os.environ.get("DGDM_CHUNK_CACHE_MB", "128"))

    def __init__(self, lvl_h, lvl_w, ch, cw, comp, offsets, nbytes, fmask):
        self.lvl_h, self.lvl_w = lvl_h, lvl_w
        self.ch, self.cw = ch, cw
        self.comp = comp
        self.offsets, self.nbytes, self.fmask = offsets, nbytes, fmask
        self._cache = None

    def _cache_handle(self):
        """The native cache (made at first use), or None for a raw dataset
        or a zero budget."""
        if self._cache is None:
            mb = self.CACHE_MB_DEFAULT
            if self.comp == COMP_RAW or mb <= 0:
                self._cache = 0
            else:
                self._cache = get_lib().dgdm_cache_new(mb << 20) or 0
        return self._cache or None

    def cache_stats(self):
        """(hits, misses, resident_bytes) of the decoded-chunk cache."""
        if not self._cache:
            return (0, 0, 0)
        h, m, b = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        get_lib().dgdm_cache_stats(self._cache, ctypes.byref(h), ctypes.byref(m),
                                   ctypes.byref(b))
        return (h.value, m.value, b.value)

    def __del__(self):
        cache = getattr(self, "_cache", None)
        if cache and _lib is not None:
            _lib.dgdm_cache_free(cache)

    @classmethod
    def from_dataset(cls, dset) -> Optional["ChunkIndex"]:
        """The index of an h5py dataset, or None when the dataset is not
        eligible for the native reader (the format rules above)."""
        if dset.chunks is None or dset.dtype != np.uint8 or dset.ndim != 3:
            return None
        ch, cw, cc = dset.chunks
        if cc != dset.shape[2] or dset.shape[2] != 3:
            return None
        comp = {None: COMP_RAW, "gzip": COMP_GZIP, "lzf": COMP_LZF}.get(dset.compression)
        if comp is None or dset.shuffle or dset.fletcher32 or dset.scaleoffset:
            return None
        lvl_h, lvl_w = int(dset.shape[0]), int(dset.shape[1])
        grid_cols = -(-lvl_w // cw)
        cells = -(-lvl_h // ch) * grid_cols
        offsets = np.zeros(cells, np.uint64)
        nbytes = np.zeros(cells, np.uint64)
        fmask = np.zeros(cells, np.uint32)

        def record(info):
            cid = (info.chunk_offset[0] // ch) * grid_cols + info.chunk_offset[1] // cw
            offsets[cid] = info.byte_offset
            nbytes[cid] = info.size
            fmask[cid] = info.filter_mask

        if hasattr(dset.id, "chunk_iter"):          # h5py >= 3.8: one C pass
            dset.id.chunk_iter(record)
        else:
            for i in range(dset.id.get_num_chunks()):
                record(dset.id.get_chunk_info(i))
        return cls(lvl_h, lvl_w, int(ch), int(cw), comp, offsets, nbytes, fmask)

    def read_patches(self, path: str, ys, xs, ph: int, pw: int,
                     out: Optional[np.ndarray] = None, fill: int = 255,
                     nthreads: Optional[int] = None, readahead: bool = True) -> np.ndarray:
        """``len(ys)`` patches of [ph, pw, 3] at level coordinates, which may
        leave the level: such pixels keep ``fill``; pixels of unallocated
        chunks read HDF5's default fill, 0. Raises RuntimeError when the
        reader fails (a file that cannot be opened or read, a corrupt chunk)."""
        lib = get_lib()
        ys = np.ascontiguousarray(ys, np.int64)
        xs = np.ascontiguousarray(xs, np.int64)
        n = len(ys)
        if out is None:
            out = np.full((n, ph, pw, 3), fill, np.uint8)
        if not (out.flags.c_contiguous and out.dtype == np.uint8
                and out.shape == (n, ph, pw, 3)):
            raise ValueError("out must be C-contiguous uint8 [n, ph, pw, 3]")
        if n == 0:
            return out
        if nthreads is None:
            nthreads = min(8, os.cpu_count() or 1)
        rc = lib.dgdm_read_patches_cached(
            str(path).encode(), self.lvl_h, self.lvl_w, self.ch, self.cw,
            _ptr(self.offsets, ctypes.c_uint64), _ptr(self.nbytes, ctypes.c_uint64),
            _ptr(self.fmask, ctypes.c_uint32), self.comp, n,
            _ptr(ys, ctypes.c_int64), _ptr(xs, ctypes.c_int64), ph, pw,
            _ptr(out, ctypes.c_uint8), int(nthreads), int(bool(readahead)),
            self._cache_handle())
        if rc != 0:
            raise RuntimeError(f"native chunk read of {path} failed: {_ERRORS.get(rc, rc)}")
        return out

    def advise_patches(self, path: str, ys, xs, ph: int, pw: int) -> None:
        """Coalesced WILLNEED for the chunk byte ranges the patches touch, no
        reads: called one batch ahead of decode so that the kernel streams
        the next batch's bytes while this batch inflates. Advisory: the
        reader's return code is not checked (the reads report their own)."""
        if len(ys) == 0:
            return
        lib = get_lib()
        ys = np.ascontiguousarray(ys, np.int64)
        xs = np.ascontiguousarray(xs, np.int64)
        lib.dgdm_advise_patches(
            str(path).encode(), self.lvl_h, self.lvl_w, self.ch, self.cw,
            _ptr(self.offsets, ctypes.c_uint64), _ptr(self.nbytes, ctypes.c_uint64),
            len(ys), _ptr(ys, ctypes.c_int64), _ptr(xs, ctypes.c_int64), ph, pw)
