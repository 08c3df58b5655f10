"""Tiled / pyramidal (Big)TIFF reader and writer in numpy, with no native
dependency: the container of most Aperio .svs slides.

A copy of the JAX package's ``preprocessing/tiff.py`` (numpy only; the port
imports nothing of that package):

  * classic TIFF (magic 42) and BigTIFF (magic 43), both byte orders;
  * tiled and stripped layouts;
  * compression: none (1), LZW (5), Deflate (8 / 32946), PackBits (32773);
    JPEG (7, with JPEGTables merging) and Aperio J2K (33003 / 33005) decode
    through Pillow, imported when such a tile is met, so they raise where
    Pillow is missing;
  * the horizontal-differencing predictor (tag 317 = 2);
  * windowed ``read_region_level`` decodes only the tiles a window touches,
    with an LRU tile cache.

``write_tiled_tiff`` and ``StreamingTiledTiffWriter`` write tiled classic /
BigTIFF pyramids (raw, deflate, LZW, or JPEG through Pillow).
"""

from __future__ import annotations

import io
import struct
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_JPEG_TABLES = 347

# value-type sizes, TIFF type id -> (struct char, size)
_TYPE_FMT = {
    1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
}

_SUPPORTED_COMPRESSION = {1, 5, 7, 8, 32773, 32946, 33003, 33005}


class TiffFormatError(ValueError):
    pass


@dataclass
class TiffPage:
    width: int
    height: int
    tile_width: int          # == width for stripped pages
    tile_height: int         # == rows_per_strip for stripped pages
    offsets: np.ndarray      # per tile/strip
    byte_counts: np.ndarray
    compression: int = 1
    photometric: int = 2
    samples: int = 3
    bits: int = 8
    predictor: int = 1
    planar: int = 1
    tiled: bool = True
    jpeg_tables: Optional[bytes] = None
    description: str = ""

    @property
    def tiles_across(self) -> int:
        return (self.width + self.tile_width - 1) // self.tile_width

    @property
    def tiles_down(self) -> int:
        return (self.height + self.tile_height - 1) // self.tile_height


def _read_ifds(f) -> List[Dict[int, tuple]]:
    """Parse all IFDs; returns per-page {tag: (type, values)} dicts."""
    header = f.read(8)
    if len(header) < 8:
        raise TiffFormatError("truncated TIFF header")
    bom = header[:2]
    if bom == b"II":
        endian = "<"
    elif bom == b"MM":
        endian = ">"
    else:
        raise TiffFormatError("not a TIFF (bad byte-order mark)")
    magic = struct.unpack(endian + "H", header[2:4])[0]
    if magic == 42:                                    # classic
        next_ifd = struct.unpack(endian + "I", header[4:8])[0]
        ifd_count_fmt, ifd_count_sz = "H", 2           # entries-per-IFD field
        ecount_fmt, ecount_sz = "I", 4                 # per-entry count field
        entry_sz, off_fmt, off_sz = 12, "I", 4
    elif magic == 43:                                  # BigTIFF
        more = f.read(8)
        off_sz_decl = struct.unpack(endian + "H", header[4:6])[0]
        if off_sz_decl != 8:
            raise TiffFormatError("unsupported BigTIFF offset size")
        next_ifd = struct.unpack(endian + "Q", more[:8])[0]
        ifd_count_fmt, ifd_count_sz = "Q", 8
        ecount_fmt, ecount_sz = "Q", 8
        entry_sz, off_fmt, off_sz = 20, "Q", 8
    else:
        raise TiffFormatError(f"bad TIFF magic {magic}")

    pages = []
    seen = set()
    while next_ifd and next_ifd not in seen and len(pages) < 64:
        seen.add(next_ifd)
        f.seek(next_ifd)
        n_entries = struct.unpack(endian + ifd_count_fmt, f.read(ifd_count_sz))[0]
        raw = f.read(n_entries * entry_sz)
        tags: Dict[int, tuple] = {}
        deferred = []   # (tag, typ, count, offset)
        for i in range(n_entries):
            ent = raw[i * entry_sz:(i + 1) * entry_sz]
            tag, typ = struct.unpack(endian + "HH", ent[:4])
            count = struct.unpack(endian + ecount_fmt, ent[4:4 + ecount_sz])[0]
            payload = ent[4 + ecount_sz:]
            if typ not in _TYPE_FMT:
                continue
            ch, sz = _TYPE_FMT[typ]
            total = sz * count
            if total <= off_sz:
                data = payload[:total]
            else:
                off = struct.unpack(endian + off_fmt, payload[:off_sz])[0]
                deferred.append((tag, typ, count, off, total))
                continue
            tags[tag] = _decode_values(endian, typ, count, data)
        # the next-IFD pointer sits right after the entry table — read it
        # BEFORE deferred tag loads move the file position
        next_ifd = struct.unpack(endian + off_fmt, f.read(off_sz))[0]
        for tag, typ, count, off, total in deferred:
            f.seek(off)
            tags[tag] = _decode_values(endian, typ, count, f.read(total))
        pages.append(tags)
    return pages


def _decode_values(endian, typ, count, data) -> tuple:
    ch, sz = _TYPE_FMT[typ]
    if typ == 2:                                   # ASCII
        return (typ, data.split(b"\0")[0].decode("latin-1", "replace"))
    if typ in (5, 10):                             # rationals -> floats
        ints = struct.unpack(endian + ("I" if typ == 5 else "i") * (2 * count),
                             data)
        return (typ, tuple(ints[i] / max(ints[i + 1], 1)
                           for i in range(0, 2 * count, 2)))
    vals = struct.unpack(endian + ch * count, data)
    return (typ, vals)


def _tag(tags, tid, default=None):
    v = tags.get(tid)
    if v is None:
        return default
    val = v[1]
    if isinstance(val, tuple) and len(val) == 1:
        return val[0]
    return val


def parse_tiff_pages(f) -> List[TiffPage]:
    pages = []
    for tags in _read_ifds(f):
        width = _tag(tags, _IMAGE_WIDTH)
        height = _tag(tags, _IMAGE_LENGTH)
        if width is None or height is None:
            continue
        tiled = _TILE_OFFSETS in tags
        if tiled:
            tw = int(_tag(tags, _TILE_WIDTH))
            th = int(_tag(tags, _TILE_LENGTH))
            offsets = np.atleast_1d(np.asarray(_tag(tags, _TILE_OFFSETS), np.int64))
            counts = np.atleast_1d(np.asarray(_tag(tags, _TILE_BYTE_COUNTS), np.int64))
        else:
            if _STRIP_OFFSETS not in tags:
                continue
            tw = int(width)
            th = int(_tag(tags, _ROWS_PER_STRIP, height))
            th = min(th, int(height))
            offsets = np.atleast_1d(np.asarray(_tag(tags, _STRIP_OFFSETS), np.int64))
            counts = np.atleast_1d(np.asarray(_tag(tags, _STRIP_BYTE_COUNTS), np.int64))
        bits = _tag(tags, _BITS_PER_SAMPLE, 8)
        if isinstance(bits, tuple):
            bits = bits[0]
        jt = None
        if _JPEG_TABLES in tags:
            vals = tags[_JPEG_TABLES][1]
            jt = bytes(vals) if not isinstance(vals, (bytes, str)) else (
                vals.encode() if isinstance(vals, str) else vals)
        pages.append(TiffPage(
            width=int(width), height=int(height),
            tile_width=tw, tile_height=th,
            offsets=offsets, byte_counts=counts,
            compression=int(_tag(tags, _COMPRESSION, 1)),
            photometric=int(_tag(tags, _PHOTOMETRIC, 2)),
            samples=int(_tag(tags, _SAMPLES_PER_PIXEL, 3)),
            bits=int(bits),
            predictor=int(_tag(tags, _PREDICTOR, 1)),
            planar=int(_tag(tags, _PLANAR_CONFIG, 1)),
            tiled=tiled,
            jpeg_tables=jt,
            description=str(_tag(tags, _IMAGE_DESCRIPTION, "") or ""),
        ))
    return pages


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-size change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitbuf = bitcnt = 0
    width = 9
    prev: Optional[bytes] = None
    pos, n = 0, len(data)
    while True:
        while bitcnt < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == EOI:
            return bytes(out)
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:                                   # KwKwK case
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF "early change": widen one code earlier than plain LZW
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW encoder (for the writer/tests)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = bitcnt = 0

    def emit(code, width):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    # (prefix_code, byte) table — O(1) per input byte (a bytes-concat key
    # turns constant runs, e.g. tile padding, quadratic)
    table: Dict[Tuple[int, int], int] = {}
    next_code = 258
    width = 9
    emit(CLEAR, width)
    w = -1
    for byte in data:
        if w < 0:
            w = byte
            continue
        key = (w, byte)
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, width)
        table[key] = next_code
        next_code += 1
        if next_code + 1 > (1 << width):
            if width < 12:
                width += 1
            else:
                emit(CLEAR, width)
                table = {}
                next_code = 258
                width = 9
        w = byte
    if w >= 0:
        emit(w, width)
    emit(EOI, width)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - h)
                i += 1
    return bytes(out)


def _merge_jpeg_tables(tables: bytes, tile: bytes) -> bytes:
    """Insert the shared JPEGTables stream into an abbreviated tile stream."""
    t = tables
    if t[:2] == b"\xff\xd8":
        t = t[2:]
    if t[-2:] == b"\xff\xd9":
        t = t[:-2]
    if tile[:2] == b"\xff\xd8":
        return b"\xff\xd8" + t + tile[2:]
    return b"\xff\xd8" + t + tile


def _decode_tile(page: TiffPage, raw: bytes, th: int, tw: int) -> np.ndarray:
    """One tile/strip -> [th, tw, samples] uint8."""
    comp = page.compression
    if comp in (7, 33003, 33005):                 # JPEG / Aperio J2K via PIL
        from PIL import Image
        buf = raw
        if comp == 7 and page.jpeg_tables:
            buf = _merge_jpeg_tables(page.jpeg_tables, raw)
        img = Image.open(io.BytesIO(buf))
        arr = np.asarray(img.convert("RGB"), np.uint8)
        # JPEG tiles are padded to MCU multiples; crop/pad to tile dims
        out = np.zeros((th, tw, 3), np.uint8)
        h = min(th, arr.shape[0]); w = min(tw, arr.shape[1])
        out[:h, :w] = arr[:h, :w]
        return out
    if comp == 1:
        data = raw
    elif comp == 5:
        data = _lzw_decode(raw)
    elif comp in (8, 32946):
        data = zlib.decompress(raw)
    elif comp == 32773:
        data = _packbits_decode(raw)
    else:
        raise TiffFormatError(f"unsupported TIFF compression {comp}")
    s = page.samples
    need = th * tw * s
    if len(data) < need:
        data = data + b"\0" * (need - len(data))
    arr = np.frombuffer(data[:need], np.uint8).reshape(th, tw, s)
    if page.predictor == 2:
        arr = np.cumsum(arr.astype(np.uint16), axis=1).astype(np.uint8)
    return arr


def parse_aperio_properties(description: str) -> Dict[str, str]:
    """'Aperio ...|AppMag = 40|MPP = 0.2520|...' -> OpenSlide-style props."""
    props: Dict[str, str] = {}
    if "Aperio" not in description:
        return props
    for part in description.split("|")[1:]:
        if "=" in part:
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            props[f"aperio.{k}"] = v
            if k == "AppMag":
                props["openslide.objective-power"] = v
            if k == "MPP":
                props["openslide.mpp-x"] = v
                props["openslide.mpp-y"] = v
    return props


class TiledTiffReader:
    """Random-access pyramid reader over a parsed TIFF.

    Pyramid levels = pages whose aspect ratio matches the baseline page
    (Aperio label/macro pages differ and are excluded), sorted by width.
    Decoded tiles live in a per-reader LRU cache.
    """

    def __init__(self, path: str | Path, cache_tiles: int = 256):
        self._path = str(path)
        from .slide_io import _advise_readahead
        _advise_readahead(path)
        self._f = open(self._path, "rb")
        all_pages = parse_tiff_pages(self._f)
        if not all_pages:
            raise TiffFormatError(f"no images in {path}")
        all_pages.sort(key=lambda p: -(p.width * p.height))
        base = all_pages[0]
        if base.compression not in _SUPPORTED_COMPRESSION:
            raise TiffFormatError(
                f"unsupported TIFF compression {base.compression}")
        aspect = base.width / max(base.height, 1)
        self.pages = [p for p in all_pages
                      if abs(p.width / max(p.height, 1) - aspect) < 0.05 * aspect
                      and p.compression in _SUPPORTED_COMPRESSION]
        self.properties = parse_aperio_properties(base.description)
        self._cache: OrderedDict[Tuple[int, int], np.ndarray] = OrderedDict()
        self._cache_tiles = cache_tiles

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return [(p.width, p.height) for p in self.pages]

    def _tile(self, level: int, ti: int) -> np.ndarray:
        key = (level, ti)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        page = self.pages[level]
        off = int(page.offsets[ti])
        cnt = int(page.byte_counts[ti])
        if off <= 0 or cnt <= 0:                        # sparse tile
            arr = np.full((page.tile_height, page.tile_width, 3), 255, np.uint8)
        else:
            self._f.seek(off)
            raw = self._f.read(cnt)
            th = page.tile_height
            if not page.tiled:                           # last strip may be short
                th = min(th, page.height - ti * page.tile_height)
            arr = _decode_tile(page, raw, th, page.tile_width)
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            elif arr.shape[-1] > 3:
                arr = arr[..., :3]
        if len(self._cache) >= self._cache_tiles:
            self._cache.popitem(last=False)
        self._cache[key] = arr
        return arr

    def read_region_level(self, level: int, x0: int, y0: int,
                          w: int, h: int) -> np.ndarray:
        """Window in LEVEL coords -> [h, w, 3] uint8 (white-padded OOB)."""
        page = self.pages[level]
        out = np.full((h, w, 3), 255, np.uint8)
        x1, y1 = x0 + w, y0 + h
        cx0 = max(x0, 0); cy0 = max(y0, 0)
        cx1 = min(x1, page.width); cy1 = min(y1, page.height)
        if cx1 <= cx0 or cy1 <= cy0:
            return out
        tw, th = page.tile_width, page.tile_height
        for ty in range(cy0 // th, (cy1 - 1) // th + 1):
            for tx in range(cx0 // tw, (cx1 - 1) // tw + 1):
                ti = ty * page.tiles_across + tx
                if ti >= len(page.offsets):
                    continue
                tile = self._tile(level, ti)
                gx0 = max(cx0, tx * tw); gy0 = max(cy0, ty * th)
                gx1 = min(cx1, tx * tw + tile.shape[1])
                gy1 = min(cy1, ty * th + tile.shape[0])
                if gx1 <= gx0 or gy1 <= gy0:
                    continue
                out[gy0 - y0:gy1 - y0, gx0 - x0:gx1 - x0] = \
                    tile[gy0 - ty * th:gy1 - ty * th,
                         gx0 - tx * tw:gx1 - tx * tw]
        return out

    def close(self) -> None:
        self._f.close()
        self._cache.clear()


# ---------------------------------------------------------------------------
# writer (fixtures / golden tests / export)
# ---------------------------------------------------------------------------

class StreamingTiledTiffWriter:
    """Incremental tiled-TIFF writer: tile payloads stream to disk as they
    are produced, IFDs are assembled at :meth:`close`.

    ``write_tiled_tiff`` needs every pyramid level in RAM (a 24.5k-px
    level 0 is ~1.8 GB); this writer holds one tile at a time, so a slide
    rendered band by band streams its encoded tiles straight out.

    Tiles may interleave across levels arbitrarily, but must arrive
    row-major WITHIN each level (the order ``write_tile`` is called is the
    order offsets are recorded).
    """

    def __init__(self, path: str | Path, level_dims: Sequence[Tuple[int, int]],
                 tile: int = 256, compression: str = "jpeg",
                 bigtiff: bool = True, jpeg_quality: int = 90,
                 description: str = ""):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.tile = tile
        self.comp_id = {"raw": 1, "lzw": 5, "deflate": 8,
                        "jpeg": 7}[compression]
        self.jpeg_quality = jpeg_quality
        self.bigtiff = bigtiff
        self.description = description
        self.level_dims = [(int(h), int(w)) for h, w in level_dims]
        self._offsets: List[List[int]] = [[] for _ in self.level_dims]
        self._counts: List[List[int]] = [[] for _ in self.level_dims]
        self._tmp = self.path.with_name(self.path.name + ".tmp")
        self._f = open(self._tmp, "wb+")
        if bigtiff:
            self._f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
            self._first_ifd_pos = 8
        else:
            self._f.write(b"II" + struct.pack("<HI", 42, 0))
            self._first_ifd_pos = 4

    def expected_tiles(self, level: int) -> int:
        h, w = self.level_dims[level]
        return ((w + self.tile - 1) // self.tile) * (
            (h + self.tile - 1) // self.tile)

    def encode(self, block: np.ndarray) -> bytes:
        block = np.asarray(block, np.uint8)
        if block.shape != (self.tile, self.tile, 3):
            padded = np.zeros((self.tile, self.tile, 3), np.uint8)
            padded[:block.shape[0], :block.shape[1]] = block
            block = padded
        if self.comp_id == 1:
            return block.tobytes()
        if self.comp_id == 8:
            return zlib.compress(block.tobytes(), 6)
        if self.comp_id == 5:
            return _lzw_encode(block.tobytes())
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(block).save(buf, "JPEG", quality=self.jpeg_quality)
        return buf.getvalue()

    def write_tile(self, level: int, block: np.ndarray) -> None:
        self._write_payload(level, self.encode(block))

    def write_tiles(self, level: int, blocks: Sequence[np.ndarray], pool=None) -> None:
        """Encode ``blocks`` (in ``pool``'s threads where one is given: zlib
        and Pillow release the GIL) and write them in their order."""
        for payload in (pool.map(self.encode, blocks) if pool is not None
                        else map(self.encode, blocks)):
            self._write_payload(level, payload)

    def _write_payload(self, level: int, payload: bytes) -> None:
        self._offsets[level].append(self._f.tell())
        self._counts[level].append(len(payload))
        self._f.write(payload)

    def close(self) -> Path:
        import os
        f, endian = self._f, "<"
        off_t = "Q" if self.bigtiff else "I"
        ifd_offsets = []
        for lvl, (h, w) in enumerate(self.level_dims):
            n_exp = self.expected_tiles(lvl)
            if len(self._offsets[lvl]) != n_exp:
                raise TiffFormatError(
                    f"level {lvl}: got {len(self._offsets[lvl])} tiles, "
                    f"expected {n_exp}")
            ifd_offsets.append(_write_ifd(
                f, endian, self.bigtiff, w, h, self.tile, self.comp_id,
                self._offsets[lvl], self._counts[lvl],
                self.description if lvl == 0 else ""))
        prev_next_field = self._first_ifd_pos
        for ifd_off in ifd_offsets:
            f.seek(prev_next_field)
            f.write(struct.pack(endian + off_t, ifd_off))
            prev_next_field = _ifd_next_field_pos(f, endian, self.bigtiff,
                                                  ifd_off)
        f.seek(prev_next_field)
        f.write(struct.pack(endian + off_t, 0))
        f.close()
        os.replace(self._tmp, self.path)
        return self.path


def write_tiled_tiff(
    path: str | Path,
    levels: Sequence[np.ndarray],
    tile: int = 256,
    compression: str = "raw",        # raw | deflate | lzw | jpeg
    bigtiff: bool = False,
    description: str = "",
    jpeg_quality: int = 90,
) -> Path:
    """Write an RGB pyramid as a tiled classic/BigTIFF.

    Each level is one IFD with 256-px-square tiles (the layout Aperio .svs
    uses), so the reader's windowed path is exercised exactly as it is on
    real slides.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    comp_id = {"raw": 1, "lzw": 5, "deflate": 8, "jpeg": 7}[compression]
    endian = "<"
    off_t = "Q" if bigtiff else "I"

    with open(path, "wb+") as f:
        if bigtiff:
            f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))  # patch IFD0 later
            first_ifd_pos = 8
        else:
            f.write(b"II" + struct.pack("<HI", 42, 0))
            first_ifd_pos = 4

        ifd_offsets = []
        for lvl_i, lvl in enumerate(levels):
            lvl = np.asarray(lvl, np.uint8)
            if lvl.ndim == 2:
                lvl = np.stack([lvl] * 3, -1)
            h, w = lvl.shape[:2]
            ta = (w + tile - 1) // tile
            td = (h + tile - 1) // tile
            offsets, counts = [], []
            for ty in range(td):
                for tx in range(ta):
                    block = np.zeros((tile, tile, 3), np.uint8)
                    sub = lvl[ty * tile:(ty + 1) * tile,
                              tx * tile:(tx + 1) * tile]
                    block[:sub.shape[0], :sub.shape[1]] = sub
                    if comp_id == 1:
                        payload = block.tobytes()
                    elif comp_id == 8:
                        payload = zlib.compress(block.tobytes(), 6)
                    elif comp_id == 5:
                        payload = _lzw_encode(block.tobytes())
                    else:                                     # jpeg
                        from PIL import Image
                        buf = io.BytesIO()
                        Image.fromarray(block).save(buf, "JPEG",
                                                    quality=jpeg_quality)
                        payload = buf.getvalue()
                    offsets.append(f.tell())
                    counts.append(len(payload))
                    f.write(payload)
            ifd_offsets.append(_write_ifd(
                f, endian, bigtiff, w, h, tile, comp_id, offsets, counts,
                description if lvl_i == 0 else ""))

        # chain the IFDs
        prev_next_field = first_ifd_pos
        for ifd_off in ifd_offsets:
            f.seek(prev_next_field)
            f.write(struct.pack(endian + off_t, ifd_off))
            prev_next_field = _ifd_next_field_pos(f, endian, bigtiff, ifd_off)
        f.seek(prev_next_field)
        f.write(struct.pack(endian + off_t, 0))
    return path


def _ifd_next_field_pos(f, endian, bigtiff, ifd_off) -> int:
    f.seek(ifd_off)
    if bigtiff:
        n = struct.unpack(endian + "Q", f.read(8))[0]
        return ifd_off + 8 + n * 20
    n = struct.unpack(endian + "H", f.read(2))[0]
    return ifd_off + 2 + n * 12


def _write_ifd(f, endian, bigtiff, w, h, tile, comp_id,
               offsets, counts, description) -> int:
    """Append one IFD (tag data first, then the entry table); returns its
    file offset. The caller patches the next-IFD chain afterwards."""
    long_t = "Q" if bigtiff else "I"
    long_id = 16 if bigtiff else 4
    inline = 8 if bigtiff else 4

    # out-of-line payloads first
    def blob(fmt, vals):
        pos = f.tell()
        f.write(struct.pack(endian + fmt * len(vals), *vals))
        return pos

    entries = []   # (tag, type_id, count, packed_inline_or_offset_bytes)

    def add(tag, type_id, vals, fmt):
        sz = _TYPE_FMT[type_id][1] * len(vals)
        if sz <= inline:
            data = struct.pack(endian + fmt * len(vals), *vals)
            data += b"\0" * (inline - len(data))
        else:
            data = struct.pack(endian + long_t, blob(fmt, vals))
        entries.append((tag, type_id, len(vals), data))

    desc_bytes = description.encode("latin-1", "replace") + b"\0"
    add(_IMAGE_WIDTH, 4, [w], "I")
    add(_IMAGE_LENGTH, 4, [h], "I")
    add(_BITS_PER_SAMPLE, 3, [8, 8, 8], "H")
    add(_COMPRESSION, 3, [comp_id], "H")
    add(_PHOTOMETRIC, 3, [6 if comp_id == 7 else 2], "H")
    if description:
        if len(desc_bytes) <= inline:
            add(_IMAGE_DESCRIPTION, 2, list(desc_bytes), "B")
        else:
            pos = f.tell()
            f.write(desc_bytes)
            entries.append((_IMAGE_DESCRIPTION, 2, len(desc_bytes),
                            struct.pack(endian + long_t, pos)))
    add(_SAMPLES_PER_PIXEL, 3, [3], "H")
    add(_PLANAR_CONFIG, 3, [1], "H")
    add(_TILE_WIDTH, 3, [tile], "H")
    add(_TILE_LENGTH, 3, [tile], "H")
    add(_TILE_OFFSETS, long_id, offsets, long_t)
    add(_TILE_BYTE_COUNTS, long_id, counts, long_t)
    entries.sort(key=lambda e: e[0])

    ifd_pos = f.tell()
    if bigtiff:
        f.write(struct.pack(endian + "Q", len(entries)))
        for tag, tid, cnt, data in entries:
            f.write(struct.pack(endian + "HHQ", tag, tid, cnt) + data)
        f.write(struct.pack(endian + "Q", 0))
    else:
        f.write(struct.pack(endian + "H", len(entries)))
        for tag, tid, cnt, data in entries:
            f.write(struct.pack(endian + "HHI", tag, tid, cnt) + data)
        f.write(struct.pack(endian + "I", 0))
    return ifd_pos
