// Transposed neighbor list: for idx [B, N, K] over a table of M rows, the
// slots that point at each table row, grouped by row and in increasing order:
//   offsets [B, M + 1] int32: group (b, m) is slots[b, offsets[b, m] : offsets[b, m + 1]]
//   slots   [B, N * K] int32: the flat slot s = n * K + k of every idx[b, n, k]
//                             in [0, M); the tail past offsets[b, M] is -1
// An index outside [0, M) is dropped, so the backward gather-sums over this
// list add nothing for it (the forward gave a zero row there). M is N for a
// gather within one graph, and the table's row count for the halo tier's
// rectangular gathers (a rank's [local || halo] rows, the rows it sends).
//
// No TPU kernel stands behind it: the TPU backward (gather_rows.py::
// _bwd_kernel) contracts one-hot tiles on the MXU and needs no list. Here it
// turns both gather backwards (csrc/gather_rows_bwd.cu, csrc/gather_agg_bwd.cu)
// from scatters with atomics into gather-sums in a fixed order. The model
// builds it once per neighbor-index tensor (one per U-Net level) in a forward
// that a gradient will be taken through.
//
// Bound on the H100: bytes, 2 * B * N * K * 4 + B * (M + 1) * 4 (idx read,
// slots and offsets written). At B=32, N=M=1024, K=8 that is 2.2 MB: ~0.7 us
// at 3.35 TB/s, under the ~1.5 us of one empty launch of the same cluster
// shape. What costs is latency: a stable counting sort of a graph is a chain
// of count -> scan -> place. One CTA a graph walks all of a graph's N*K slots
// on one SM (at B 1, one SM of 132), and [M][16 warps] counters leave shared
// memory above M ~ 2480; a cluster spreads both.
//
// Design: one thread-block cluster of C CTAs of W warps per graph
// (ops/kernels/neighbor_transpose.py::launch_plan: C the largest power of two
// <= 16 with B * C <= 132, so 4 at B = 32 and 16 at B <= 8; W = 8 where the
// counters fit shared memory, else 4). CTA r owns the contiguous slot segment
// [r * seg, (r + 1) * seg); its warps own contiguous parts of it.
//   1. Count. Each warp walks its part in 32-slot tiles. A tile's keys
//      (row << 5 | lane) are sorted across the warp by a 15-stage bitonic
//      network of shuffles, so each row's lanes sit together in lane order;
//      the group's first lane adds the group's size to the warp's own
//      counter of the row (cnt [W][M] in shared memory), and the old value
//      plus the lane's place in the group is the slot's rank inside the
//      warp's part. The warp's last batch of tiles keeps its rows and ranks
//      in registers until step 4, earlier batches in a rank buffer.
//      (__match_any_sync grouped the lanes more slowly on the H100.)
//   2. Per CTA, four rows a thread: cnt becomes each warp's start inside the
//      CTA's share of the row, tot [M] the share; each share goes by
//      distributed shared memory (DSMEM) to the CTA that scans the row's
//      chunk, and the CTA's share of each chunk to every CTA. cluster.sync().
//   3. Each CTA scans its chunk of rows from its own shared memory: the
//      row's offset (the chunks before it, the rows before it) goes to
//      offsets, and where each CTA's share of the row starts goes into that
//      CTA's tot by DSMEM. cluster.sync(): the last access to another CTA.
//   4. Place: each slot goes to tot[row] + cnt[its warp][row] + its rank,
//      with no order left to keep.
// CTAs are in slot order, warps in slot order within a CTA, tiles in slot
// order within a warp and lanes in slot order within a tile, so every group
// comes out in increasing slot order: bit-equal to a stable sort, and the
// same from call to call (a counter is moved by one warp only, in program
// order; the scans add integers). DSMEM is written, never read: every CTA
// pushes to its peers and reads its own shared memory, starting on a
// different peer than its neighbours. Shared memory is 4 * ((W + 1) * M + C
// * chunk) bytes a CTA, 192 KiB at M = 8192 (W = 4, C = 16): the counters
// stay on chip at every bucket the presets and the node-sharded tier use.
// Where even W = 4 does not fit (M above ~9550 rows), the same layout lives
// in a global scratch buffer, one block per CTA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCluster = 16;        // CTAs a graph at most (above 8: non-portable)
constexpr int kBatch = 8;              // 32-slot tiles whose indices load together
constexpr int kSmemLimit = 224 * 1024; // dynamic shared memory a CTA at most
constexpr unsigned kNone = (1u << 27) - 1;   // the sort key of a slot outside [0, rows)

// Int32 words of one CTA's counters for W warps over M rows, in a cluster of
// C CTAs that scan chunks of `chunk` rows (a multiple of 4): cnt [W][M] and
// tot [M] (M padded to 4), then [C][chunk], the CTAs' shares of its chunk.
__host__ __device__ __forceinline__ int64_t pad4(int64_t n) { return (n + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int64_t cta_ints(int64_t rows, int warps, int cluster,
                                                     int64_t chunk) {
  return (warps + 1) * pad4(rows) + cluster * chunk;
}

// The warp's 32 values in increasing order across its lanes (a bitonic
// network of 15 shuffle stages).
__device__ __forceinline__ unsigned warp_sort(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned o = __shfl_xor_sync(kFullMask, v, j);
      const bool low = (lane & j) == 0, up = (lane & k) == 0 || k == 32;
      v = low == up ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The sort keys (row << 5 | lane) of the kBatch tiles from slot s0: kNone
// for a slot outside [0, rows) or at or past hi.
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ ib, int s0, int hi,
                                          int rows, unsigned (&key)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int s = s0 + u * 32 + lane;
    const int v = s < hi ? __ldg(ib + s) : -1;
    key[u] = (v >= 0 && v < rows ? static_cast<unsigned>(v) : kNone) << 5 | lane;
  }
}

// One warp's count over its part [lo, hi) of the graph's slots, kBatch tiles
// at a time. A tile's keys are sorted across the warp, so each row's lanes
// sit together in lane order; the first of them adds the group's size to
// this warp's counter of the row, whose old value (the warp's earlier slots
// of that row) plus the group's lanes before a lane is that slot's rank.
// Only this warp moves the counter, in tile order, so the ranks follow slot
// order. `key` holds the first batch's keys on entry and the last batch's
// sorted keys on return, `rk` their ranks; earlier batches' ranks go to
// rank[s]. Returns the last batch's first slot.
__device__ int count(const int32_t* __restrict__ ib, int* cnt, int32_t* __restrict__ rank,
                     int lo, int hi, int rows, unsigned (&key)[kBatch], int (&rk)[kBatch]) {
  const int lane = threadIdx.x & 31;
  const unsigned le = (2u << lane) - 1u;               // lanes 0..lane
  for (int s0 = lo;; s0 += 32 * kBatch) {             // warp-uniform
#pragma unroll
    for (int u = 0; u < kBatch; ++u) key[u] = warp_sort(key[u]);
    int first[kBatch], size[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned row = key[u] >> 5;
      const unsigned prev = __shfl_up_sync(kFullMask, row, 1);
      const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != row);
      first[u] = 31 - __clz(heads & le);               // this lane's group starts here
      const unsigned after = heads & ~le;
      size[u] = first[u] == lane && row != kNone ? (after ? __ffs(after) - 1 : 32) - lane : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rk[u] = size[u] ? atomicAdd(cnt + (key[u] >> 5), size[u]) : 0;
      __syncwarp();                                    // tile u's count moves before u + 1's
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      rk[u] = __shfl_sync(kFullMask, rk[u], first[u]) + lane - first[u];
    if (s0 + 32 * kBatch >= hi) return s0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if ((key[u] >> 5) != kNone) rank[s0 + u * 32 + (key[u] & 31)] = rk[u];
    load_keys(ib, s0 + 32 * kBatch, hi, rows, key);
  }
}

template <int W>
__global__ void __launch_bounds__(32 * W)
neighbor_transpose_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ offsets,
                          int32_t* __restrict__ slots, int32_t* __restrict__ rank_buf,
                          int* __restrict__ scratch, int nk, int rows, int seg, int chunk) {
  constexpr int kThreads = 32 * W;
  extern __shared__ int4 smem[];
  __shared__ int part_sum[kMaxCluster][kMaxCluster];  // [CTA][chunk]: the CTA's share of the chunk
  __shared__ int chunk_sum[kMaxCluster];               // this CTA's share of each chunk, then
                                                       // each chunk's total
  __shared__ int warp_sums[W];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = static_cast<int>(pad4(rows));        // a warp's counters: row stride
  const int64_t stride = cta_ints(rows, W, nc, chunk);
  int* cnt = scratch == nullptr ? reinterpret_cast<int*>(smem)
                                : scratch + (b * nc + me) * stride;     // [W][rs]
  int* tot = cnt + W * rs;                             // [rs]
  int* shares = tot + rs;                              // [nc][chunk]
  // the block of CTA r of this cluster: its shared memory, or its scratch
  auto block_of = [&](int r) -> int* {
    return scratch == nullptr ? cluster.map_shared_rank(cnt, r) : scratch + (b * nc + r) * stride;
  };
  const int32_t* ib = idx + b * nk;
  int32_t* ob = offsets + b * (rows + 1);
  int32_t* sb = slots + b * nk;
  int32_t* rb = rank_buf + b * nk;

  // 1. count this CTA's segment, per warp; each slot's rank within its
  // warp's part (the first batch's indices load while the counters are zeroed)
  const int lo = static_cast<int>(min(static_cast<int64_t>(nk), static_cast<int64_t>(me) * seg));
  const int hi = static_cast<int>(min(static_cast<int64_t>(nk), static_cast<int64_t>(lo) + seg));
  const int part = seg / W;                            // a multiple of 32
  const int wlo = static_cast<int>(min(static_cast<int64_t>(hi),
                                       static_cast<int64_t>(lo) + warp * part));
  const int whi = static_cast<int>(min(static_cast<int64_t>(hi),
                                       static_cast<int64_t>(wlo) + part));
  unsigned key[kBatch];
  int rk[kBatch];
  load_keys(ib, wlo, whi, rows, key);
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  for (int i = tid; i < W * rs / 4; i += kThreads) cnt4[i] = make_int4(0, 0, 0, 0);
  if (tid < kMaxCluster) chunk_sum[tid] = 0;
  __syncthreads();
  const int last = count(ib, cnt + warp * rs, rb, wlo, whi, rows, key, rk);
  __syncthreads();

  // 2. four rows a thread: where each warp's slots start in the CTA's share
  // of the row, the share itself (tot), sent on to the CTA that scans the
  // row's chunk, and the share of each chunk, sent to every CTA
  int4* tot4 = reinterpret_cast<int4*>(tot);
  const int quads = rs / 4;
  for (int q = tid; q < quads; q += kThreads) {
    const int i = (q + me * quads / nc) % quads;       // CTAs start on different chunks
    int4 run = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int4 v = cnt4[w * (rs / 4) + i];
      cnt4[w * (rs / 4) + i] = run;
      run = make_int4(run.x + v.x, run.y + v.y, run.z + v.z, run.w + v.w);
    }
    tot4[i] = run;
    const int j = 4 * i / chunk;                       // four rows in one chunk
    *reinterpret_cast<int4*>(block_of(j) + (W + 1) * rs + me * chunk + (4 * i - j * chunk)) = run;
    atomicAdd(&chunk_sum[j], run.x + run.y + run.z + run.w);
  }
  __syncthreads();
  for (int t = tid; t < nc * nc; t += kThreads)
    *cluster.map_shared_rank(&part_sum[me][t % nc], (t / nc + me) % nc) = chunk_sum[t % nc];
  cluster.sync();

  // 3. this CTA's chunk of rows, one row a thread in rounds: the row's
  // total over the CTAs' shares, its offset (the chunks before it, the rows
  // before it in the chunk), and where each CTA's share of it starts, sent
  // into that CTA's tot
  if (tid < nc) {
    int col = 0;
    for (int r = 0; r < nc; ++r) col += part_sum[r][tid];
    chunk_sum[tid] = col;
  }
  __syncthreads();
  int at0 = 0, total = 0;                              // at0: the first row's offset
  for (int j = 0; j < nc; ++j) {
    if (j == me) at0 = total;
    total += chunk_sum[j];
  }
  const int klo = min(rows, me * chunk), khi = min(rows, klo + chunk);
  for (int m0 = klo; m0 < khi; m0 += kThreads) {       // block-uniform
    const int m = m0 + tid;
    int row = 0;
    if (m < khi)
      for (int r = 0; r < nc; ++r) row += shares[r * chunk + (m - klo)];
    int x = row;                                       // inclusive scan over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int below = 0, round = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      below += w < warp ? warp_sums[w] : 0;
      round += warp_sums[w];
    }
    if (m < khi) {
      int at = at0 + below + x - row;
      ob[m] = at;
      for (int r = 0; r < nc; ++r) {
        block_of(r)[W * rs + m] = at;                  // where CTA r's share of m starts
        at += shares[r * chunk + (m - klo)];
      }
    }
    at0 += round;
    __syncthreads();                                   // warp_sums read before the next round
  }
  if (me == 0 && tid == 0) ob[rows] = total;
  for (int64_t i = total + static_cast<int64_t>(me) * kThreads + tid; i < nk;
       i += static_cast<int64_t>(nc) * kThreads)
    sb[i] = -1;
  cluster.sync();                                      // last access to another CTA's memory

  // 4. place: every slot at its CTA's start of its row, plus where its
  // warp's slots start, plus its rank (no order left to keep); the warp's
  // last batch from registers, earlier ones from the rank buffer
  const int* mine = cnt + warp * rs;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const unsigned row = key[u] >> 5;
    if (row != kNone) sb[tot[row] + mine[row] + rk[u]] = last + u * 32 + (key[u] & 31);
  }
  for (int s0 = wlo + lane; s0 < last; s0 += 32 * kBatch) {
    int m[kBatch], r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * 32;
      m[u] = s < last ? __ldg(ib + s) : -1;
      r[u] = m[u] >= 0 && m[u] < rows ? rb[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (m[u] >= 0 && m[u] < rows) sb[tot[m[u]] + mine[m[u]] + r[u]] = s0 + u * 32;
  }
}

// The kernel's attributes, the same at every launch: dynamic shared memory
// up to kSmemLimit, clusters of up to 16 CTAs.
template <int W>
cudaError_t configure() {
  const cudaError_t err = cudaFuncSetAttribute(
      neighbor_transpose_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(neighbor_transpose_kernel<W>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// B clusters of `cluster` CTAs of 32 * W threads; attr is the caller's.
cudaLaunchConfig_t launch_config(int64_t batch, int64_t cluster, int warps, int64_t smem,
                                 void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * cluster));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int W>
cudaError_t launch(const void* idx, void* offsets, void* slots, void* ranks, void* scratch,
                   int64_t batch, int64_t nk, int64_t rows, int64_t cluster, int64_t seg,
                   int64_t chunk, int64_t smem, void* stream) {
  const cudaError_t err = configure<W>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(batch, cluster, W, smem, stream, attr);
  return cudaLaunchKernelEx(&cfg, neighbor_transpose_kernel<W>,
                            static_cast<const int32_t*>(idx), static_cast<int32_t*>(offsets),
                            static_cast<int32_t*>(slots), static_cast<int32_t*>(ranks),
                            static_cast<int*>(scratch), static_cast<int>(nk),
                            static_cast<int>(rows), static_cast<int>(seg),
                            static_cast<int>(chunk));
}

template <int W>
int max_clusters(int64_t cluster, int64_t smem) {
  cudaError_t err = configure<W>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, W, smem, nullptr, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, neighbor_transpose_kernel<W>, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

}  // namespace

// Launches on `stream`, on the caller's current device: B clusters of
// `cluster` CTAs of 32 * `warps` threads (warps 4 or 8), `smem` bytes of
// dynamic shared memory each (0 with `scratch`: then an int32 buffer of B *
// cluster * cta_ints words, which the kernel zeroes itself). idx [B, N, K]
// over a table of `rows` (M) rows, nk = N * K; offsets [B, M + 1], slots
// [B, N * K]; ranks an int32 buffer of B * N * K words. `seg` (a multiple of
// 32 * warps) and `chunk` (a multiple of 4) are a CTA's slots and rows.
// Returns the CUDA error of the launch: a cluster shape or a shared-memory
// size that the card refuses is never run.
extern "C" int neighbor_transpose_launch(const void* idx, void* offsets, void* slots,
                                         void* ranks, void* scratch, int64_t batch,
                                         int64_t nk, int64_t rows, int64_t warps,
                                         int64_t cluster, int64_t seg, int64_t chunk,
                                         int64_t smem, void* stream) {
  if (batch == 0) return 0;
  if ((warps != 4 && warps != 8) || cluster < 1 || cluster > kMaxCluster ||
      seg % (32 * warps) != 0 || smem > kSmemLimit ||
      (rows > 0 && (chunk < 4 || chunk % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      warps == 4 ? launch<4>(idx, offsets, slots, ranks, scratch, batch, nk, rows, cluster, seg,
                             chunk, smem, stream)
                 : launch<8>(idx, offsets, slots, ranks, scratch, batch, nk, rows, cluster, seg,
                             chunk, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of a plan's shape (`cluster` CTAs of 32 * `warps` threads,
// `smem` bytes each) that the card holds at once; 0 where it cannot launch
// the plan, -code on an error.
extern "C" int neighbor_transpose_max_clusters(int64_t warps, int64_t cluster, int64_t smem) {
  switch (warps) {
    case 4: return max_clusters<4>(cluster, smem);
    case 8: return max_clusters<8>(cluster, smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
