// Native direct-chunk reader for the dgdm_wsi chunked-HDF5 slide layout.
//
// A copy of the JAX package's dgdm_histopath_tpu/native/dgdm_io.cpp (the
// port imports nothing of that package). It is host IO, not a CUDA kernel:
// Python hands over the chunk index (byte offsets and sizes, enumerated once
// through h5py), and this file does pread(2) + inflate + window assembly
// straight into the caller's patch buffer, chunk-major so that every chunk
// is read and decoded once per batch, without the h5py/HDF5 per-read
// machinery. Targeted POSIX_FADV_WILLNEED on the chunk byte ranges a batch
// touches replaces whole-file readahead, so a cold cache streams only the
// bytes the tissue-gated patches need.
//
// Supported chunk filters: none (raw), gzip/deflate (zlib), LZF (the h5py
// filter; decoder below implements Marc Lehmann's LZF format). A chunk
// whose HDF5 filter_mask has bit 0 set was stored unfiltered and is
// treated as raw. Layout contract: dataset shape [H, W, 3] uint8, chunk
// shape [ch, cw, 3].

#include <zlib.h>

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum CompCode { COMP_RAW = 0, COMP_GZIP = 1, COMP_LZF = 2 };

enum ErrCode {
  ERR_OK = 0,
  ERR_OPEN = -1,
  ERR_PREAD = -2,
  ERR_DECOMP = -3,
  ERR_BADARG = -4,
};

// LZF decompression (format of libLZF / the h5py LZF filter).
// Returns decompressed size, or -1 on malformed input / overflow.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_cap) {
  const uint8_t* ip = in;
  const uint8_t* in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* out_end = out + out_cap;
  while (ip < in_end) {
    uint32_t ctrl = *ip++;
    if (ctrl < 32) {  // literal run of ctrl+1 bytes
      int64_t len = ctrl + 1;
      if (op + len > out_end || ip + len > in_end) return -1;
      std::memcpy(op, ip, len);
      op += len;
      ip += len;
    } else {  // back reference
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      len += 2;
      if (ip >= in_end) return -1;
      int64_t dist = ((ctrl & 0x1f) << 8) + 1 + *ip++;
      const uint8_t* ref = op - dist;
      if (ref < out || op + len > out_end) return -1;
      // overlapping copy must run byte-by-byte
      while (len--) *op++ = *ref++;
    }
  }
  return op - out;
}

struct ChunkTask {
  int64_t cid;      // linear chunk id (row-major over the chunk grid)
  uint64_t offset;  // byte offset in file (0 => unallocated)
  uint64_t nbytes;
  uint32_t fmask;
  std::vector<int32_t> patches;  // indices of patches touching this chunk
};

// Decoded-chunk cache: consecutive patch batches over a column-major grid
// share ~24% of their chunk columns (measured on the 24576px/256px-patch/
// 512px-chunk predict geometry), and with FIFO eviction the previous
// batch's chunks are exactly what the next batch re-touches. Keyed by file
// byte offset (unique per chunk within one dataset — the cache handle is
// per ChunkIndex). shared_ptr buffers keep in-flight assembly safe across
// concurrent eviction.
struct DecodedChunkCache {
  std::mutex mu;
  int64_t max_bytes;
  int64_t cur_bytes{0};
  uint64_t hits{0}, misses{0};
  std::unordered_map<uint64_t, std::shared_ptr<std::vector<uint8_t>>> map;
  std::deque<uint64_t> fifo;
  explicit DecodedChunkCache(int64_t mb) : max_bytes(mb) {}
};

}  // namespace

namespace {

// Reads n patches of size [ph, pw, 3] from one pyramid level stored as a
// chunked uint8 [lvl_h, lvl_w, 3] dataset. Patch coords (ys[i], xs[i]) are
// level coords and may be negative / extend past the level bounds; `out`
// must be prefilled by the caller with its out-of-bounds fill value.
// Pixels inside the level bounds are always written (unallocated chunks
// write the HDF5 default fill, 0). Returns ERR_OK or a negative ErrCode.
// `cache` (optional) is a DecodedChunkCache: chunks found there skip
// pread+decode entirely; freshly decoded chunks are inserted (FIFO
// eviction at max_bytes).
int read_patches_impl(const char* path, int64_t lvl_h, int64_t lvl_w,
                      int64_t ch, int64_t cw, const uint64_t* chunk_off,
                      const uint64_t* chunk_nbytes, const uint32_t* fmask,
                      int comp, int64_t n, const int64_t* ys,
                      const int64_t* xs, int64_t ph, int64_t pw, uint8_t* out,
                      int nthreads, int do_readahead,
                      DecodedChunkCache* cache) {
  if (ch <= 0 || cw <= 0 || ph <= 0 || pw <= 0 || lvl_h <= 0 || lvl_w <= 0)
    return ERR_BADARG;
  if (comp != COMP_RAW && comp != COMP_GZIP && comp != COMP_LZF)
    return ERR_BADARG;
  const int64_t grid_rows = (lvl_h + ch - 1) / ch;
  const int64_t grid_cols = (lvl_w + cw - 1) / cw;

  // chunk id -> list of touching patches (dense map over the chunk grid;
  // a 200k-px level at 512px chunks is ~153k entries, a few MB)
  std::vector<std::vector<int32_t>> touch(
      static_cast<size_t>(grid_rows * grid_cols));
  for (int64_t i = 0; i < n; ++i) {
    int64_t y0 = std::max<int64_t>(ys[i], 0);
    int64_t x0 = std::max<int64_t>(xs[i], 0);
    int64_t y1 = std::min<int64_t>(ys[i] + ph, lvl_h);
    int64_t x1 = std::min<int64_t>(xs[i] + pw, lvl_w);
    if (y1 <= y0 || x1 <= x0) continue;
    for (int64_t cr = y0 / ch; cr <= (y1 - 1) / ch; ++cr)
      for (int64_t cc = x0 / cw; cc <= (x1 - 1) / cw; ++cc)
        touch[static_cast<size_t>(cr * grid_cols + cc)].push_back(
            static_cast<int32_t>(i));
  }

  std::vector<ChunkTask> tasks;
  for (int64_t cid = 0; cid < grid_rows * grid_cols; ++cid) {
    auto& lst = touch[static_cast<size_t>(cid)];
    if (lst.empty()) continue;
    ChunkTask t;
    t.cid = cid;
    t.offset = chunk_off[cid];
    t.nbytes = chunk_nbytes[cid];
    t.fmask = fmask ? fmask[cid] : 0;
    t.patches = std::move(lst);
    tasks.push_back(std::move(t));
  }
  // file-offset order => sequential disk access on a cold cache
  std::sort(tasks.begin(), tasks.end(),
            [](const ChunkTask& a, const ChunkTask& b) {
              return a.offset < b.offset;
            });

  int fd = open(path, O_RDONLY);
  if (fd < 0) return ERR_OPEN;

  if (do_readahead) {
    // hand the kernel the exact IO plan (coalescing adjacent ranges);
    // WILLNEED is async — reads below then hit already-inflight pages
    uint64_t ra_off = 0, ra_end = 0;
    for (const auto& t : tasks) {
      if (!t.offset || !t.nbytes) continue;
      if (ra_end && t.offset <= ra_end + (1u << 20)) {
        ra_end = std::max(ra_end, t.offset + t.nbytes);
        continue;
      }
      if (ra_end) posix_fadvise(fd, ra_off, ra_end - ra_off, POSIX_FADV_WILLNEED);
      ra_off = t.offset;
      ra_end = t.offset + t.nbytes;
    }
    if (ra_end) posix_fadvise(fd, ra_off, ra_end - ra_off, POSIX_FADV_WILLNEED);
  }

  const int64_t chunk_raw = ch * cw * 3;
  std::atomic<size_t> next(0);
  std::atomic<int> err(ERR_OK);
  int workers = std::max(1, nthreads);
  workers = static_cast<int>(
      std::min<size_t>(static_cast<size_t>(workers), tasks.size()));
  if (workers < 1) workers = 1;

  auto worker = [&]() {
    std::vector<uint8_t> readbuf;
    std::vector<uint8_t> chunkbuf(static_cast<size_t>(chunk_raw));
    for (;;) {
      size_t k = next.fetch_add(1);
      if (k >= tasks.size() || err.load() != ERR_OK) break;
      const ChunkTask& t = tasks[k];
      const uint8_t* src = nullptr;
      std::shared_ptr<std::vector<uint8_t>> held;  // pins a cached buffer
      if (cache && t.offset && t.nbytes) {
        std::lock_guard<std::mutex> g(cache->mu);
        auto it = cache->map.find(t.offset);
        if (it != cache->map.end()) {
          held = it->second;
          ++cache->hits;
        } else {
          ++cache->misses;
        }
      }
      if (held) {
        src = held->data();
      } else if (!t.offset || !t.nbytes) {
        // unallocated chunk: HDF5 default fill (0)
        std::memset(chunkbuf.data(), 0, static_cast<size_t>(chunk_raw));
        src = chunkbuf.data();
      } else {
        readbuf.resize(t.nbytes);
        ssize_t got = 0;
        while (got < static_cast<ssize_t>(t.nbytes)) {
          ssize_t r = pread(fd, readbuf.data() + got, t.nbytes - got,
                            static_cast<off_t>(t.offset + got));
          if (r <= 0) {
            err.store(ERR_PREAD);
            break;
          }
          got += r;
        }
        if (err.load() != ERR_OK) break;
        bool raw = (comp == COMP_RAW) || (t.fmask & 1u);
        if (raw) {
          if (static_cast<int64_t>(t.nbytes) < chunk_raw) {
            err.store(ERR_DECOMP);
            break;
          }
          src = readbuf.data();
        } else if (comp == COMP_GZIP) {
          uLongf dlen = static_cast<uLongf>(chunk_raw);
          if (uncompress(chunkbuf.data(), &dlen, readbuf.data(),
                         static_cast<uLong>(t.nbytes)) != Z_OK ||
              dlen != static_cast<uLongf>(chunk_raw)) {
            err.store(ERR_DECOMP);
            break;
          }
          src = chunkbuf.data();
        } else {  // COMP_LZF
          int64_t dlen = lzf_decompress(readbuf.data(),
                                        static_cast<int64_t>(t.nbytes),
                                        chunkbuf.data(), chunk_raw);
          if (dlen != chunk_raw) {
            err.store(ERR_DECOMP);
            break;
          }
          src = chunkbuf.data();
        }
        if (cache && src) {
          // insert a private copy; shared_ptr keeps it alive for any
          // reader still assembling from it after eviction
          held = std::make_shared<std::vector<uint8_t>>(src,
                                                        src + chunk_raw);
          std::lock_guard<std::mutex> g(cache->mu);
          if (cache->map.emplace(t.offset, held).second) {
            cache->fifo.push_back(t.offset);
            cache->cur_bytes += chunk_raw;
            while (cache->cur_bytes > cache->max_bytes &&
                   !cache->fifo.empty()) {
              uint64_t victim = cache->fifo.front();
              cache->fifo.pop_front();
              if (cache->map.erase(victim))
                cache->cur_bytes -= chunk_raw;
            }
          }
          src = held->data();
        }
      }
      // window assembly: copy this chunk's intersection into each patch
      const int64_t cr = t.cid / grid_cols, cc = t.cid % grid_cols;
      const int64_t cy0 = cr * ch, cx0 = cc * cw;
      const int64_t cy1 = std::min(cy0 + ch, lvl_h);
      const int64_t cx1 = std::min(cx0 + cw, lvl_w);
      for (int32_t pi : t.patches) {
        const int64_t py = ys[pi], px = xs[pi];
        const int64_t gy0 = std::max(py, cy0), gy1 = std::min(py + ph, cy1);
        const int64_t gx0 = std::max(px, cx0), gx1 = std::min(px + pw, cx1);
        if (gy1 <= gy0 || gx1 <= gx0) continue;
        const int64_t wbytes = (gx1 - gx0) * 3;
        uint8_t* dst_base = out + ((pi * ph + (gy0 - py)) * pw + (gx0 - px)) * 3;
        const uint8_t* src_base =
            src + ((gy0 - cy0) * cw + (gx0 - cx0)) * 3;
        for (int64_t gy = gy0; gy < gy1; ++gy) {
          std::memcpy(dst_base, src_base, static_cast<size_t>(wbytes));
          dst_base += pw * 3;
          src_base += cw * 3;
        }
      }
    }
  };

  if (workers == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int w = 0; w < workers; ++w) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  close(fd);
  return err.load();
}

}  // namespace

extern "C" {

int dgdm_read_patches(const char* path, int64_t lvl_h, int64_t lvl_w,
                      int64_t ch, int64_t cw, const uint64_t* chunk_off,
                      const uint64_t* chunk_nbytes, const uint32_t* fmask,
                      int comp, int64_t n, const int64_t* ys,
                      const int64_t* xs, int64_t ph, int64_t pw, uint8_t* out,
                      int nthreads, int do_readahead) {
  return read_patches_impl(path, lvl_h, lvl_w, ch, cw, chunk_off,
                           chunk_nbytes, fmask, comp, n, ys, xs, ph, pw, out,
                           nthreads, do_readahead, nullptr);
}

// Cached variant: `cache` from dgdm_cache_new (may be null = uncached).
int dgdm_read_patches_cached(const char* path, int64_t lvl_h, int64_t lvl_w,
                             int64_t ch, int64_t cw,
                             const uint64_t* chunk_off,
                             const uint64_t* chunk_nbytes,
                             const uint32_t* fmask, int comp, int64_t n,
                             const int64_t* ys, const int64_t* xs, int64_t ph,
                             int64_t pw, uint8_t* out, int nthreads,
                             int do_readahead, void* cache) {
  return read_patches_impl(path, lvl_h, lvl_w, ch, cw, chunk_off,
                           chunk_nbytes, fmask, comp, n, ys, xs, ph, pw, out,
                           nthreads, do_readahead,
                           static_cast<DecodedChunkCache*>(cache));
}

void* dgdm_cache_new(int64_t max_bytes) {
  if (max_bytes <= 0) return nullptr;
  return new DecodedChunkCache(max_bytes);
}

void dgdm_cache_free(void* cache) {
  delete static_cast<DecodedChunkCache*>(cache);
}

void dgdm_cache_stats(void* cache, int64_t* hits, int64_t* misses,
                      int64_t* bytes) {
  auto* c = static_cast<DecodedChunkCache*>(cache);
  int64_t h = 0, m = 0, b = 0;
  if (c) {
    std::lock_guard<std::mutex> g(c->mu);
    h = static_cast<int64_t>(c->hits);
    m = static_cast<int64_t>(c->misses);
    b = c->cur_bytes;
  }
  if (hits) *hits = h;
  if (misses) *misses = m;
  if (bytes) *bytes = b;
}

// Advise-only entry: compute the chunk set the given patches touch and
// issue coalesced POSIX_FADV_WILLNEED for their byte ranges — no reads, no
// decode. Called one BATCH AHEAD by the decode pipeline: while batch i's
// chunks inflate on the CPU, the kernel streams batch i+1's bytes from
// disk in the background, so a cold cache overlaps seek/transfer latency
// with decompression instead of serializing them. Returns ERR_OK or a
// negative ErrCode.
int dgdm_advise_patches(const char* path, int64_t lvl_h, int64_t lvl_w,
                        int64_t ch, int64_t cw, const uint64_t* chunk_off,
                        const uint64_t* chunk_nbytes, int64_t n,
                        const int64_t* ys, const int64_t* xs, int64_t ph,
                        int64_t pw) {
  if (ch <= 0 || cw <= 0 || ph <= 0 || pw <= 0 || lvl_h <= 0 || lvl_w <= 0)
    return ERR_BADARG;
  const int64_t grid_cols = (lvl_w + cw - 1) / cw;
  std::vector<std::pair<uint64_t, uint64_t>> ranges;  // (offset, nbytes)
  std::vector<char> seen(
      static_cast<size_t>(((lvl_h + ch - 1) / ch) * grid_cols), 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t y0 = std::max<int64_t>(ys[i], 0);
    int64_t x0 = std::max<int64_t>(xs[i], 0);
    int64_t y1 = std::min<int64_t>(ys[i] + ph, lvl_h);
    int64_t x1 = std::min<int64_t>(xs[i] + pw, lvl_w);
    if (y1 <= y0 || x1 <= x0) continue;
    for (int64_t cr = y0 / ch; cr <= (y1 - 1) / ch; ++cr)
      for (int64_t cc = x0 / cw; cc <= (x1 - 1) / cw; ++cc) {
        size_t cid = static_cast<size_t>(cr * grid_cols + cc);
        if (seen[cid]) continue;
        seen[cid] = 1;
        if (chunk_off[cid] && chunk_nbytes[cid])
          ranges.emplace_back(chunk_off[cid], chunk_nbytes[cid]);
      }
  }
  if (ranges.empty()) return ERR_OK;
  std::sort(ranges.begin(), ranges.end());
  int fd = open(path, O_RDONLY);
  if (fd < 0) return ERR_OPEN;
  uint64_t ra_off = 0, ra_end = 0;
  for (const auto& r : ranges) {
    if (ra_end && r.first <= ra_end + (1u << 20)) {
      ra_end = std::max(ra_end, r.first + r.second);
      continue;
    }
    if (ra_end) posix_fadvise(fd, ra_off, ra_end - ra_off, POSIX_FADV_WILLNEED);
    ra_off = r.first;
    ra_end = r.first + r.second;
  }
  if (ra_end) posix_fadvise(fd, ra_off, ra_end - ra_off, POSIX_FADV_WILLNEED);
  close(fd);
  return ERR_OK;
}

// ABI/version probe for the ctypes loader.
int dgdm_io_version() { return 3; }

}  // extern "C"
