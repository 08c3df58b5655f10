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
// Bound on the H100: bytes. At B=32, N=M=1024, K=8 it reads idx (1.0 MB) and
// writes offsets and slots (1.2 MB): ~0.7 us at 3.35 TB/s. It runs far from
// that: one block per graph (32 blocks at the main shape, 132 SMs) does a
// stable counting sort. Design: the block's 16 warps each own a contiguous
// segment of the graph's N*K slots. Pass 1 counts, per warp, the slots of
// each destination m into cnt[m][warp] (integer atomic adds in shared
// memory: a count does not depend on their order). An exclusive scan over
// cnt in (m, warp) order gives each warp its first position per destination;
// pass 2 walks the segments again and writes each slot at its warp's cursor
// plus its rank among the lanes of its 32-slot tile with the same
// destination below it (found with one ballot per bit of the destination, 11
// at M = 1024). Segments are in slot order and ranks in lane order, so each
// group comes out in increasing slot order: the result is bit-equal to a
// stable sort, from run to run. One SM serves a whole graph, so at a small
// batch the walks' instructions, not memory, set the time. cnt lives in
// shared memory (~66 * M bytes) up to the wrapper's limit, above it in a
// global scratch buffer of the same layout.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;              // 32-slot tiles whose indices load together

// cnt index of cell i = m * kWarps + warp, one pad word per 32 cells: a
// thread's run of consecutive cells in the scan then starts on another bank
// than its neighbor's.
__host__ __device__ __forceinline__ int64_t at(int64_t i) { return i + (i >> 5); }

// The lanes of the warp whose key equals this lane's, for keys of `bits`
// bits: one ballot per bit, so a warp's tile costs `bits` ballots.
__device__ __forceinline__ unsigned peers(int key, int bits) {
  unsigned same = kFullMask;
  for (int i = 0; i < bits; ++i) {
    const bool one = (key >> i) & 1;
    const unsigned ones = __ballot_sync(kFullMask, one);
    same &= one ? ones : ~ones;
  }
  return same;
}

// Exclusive prefix of v over the block in thread order; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_sums[lane] = t;            // inclusive, per warp
    if (lane == kWarps - 1) *total = t;
  }
  __syncthreads();
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// One warp's walk over its segment [lo, hi) of the graph's slots. kPlace
// false: count into cnt[at(m * kWarps + warp)]; true: write each slot at the
// cursor there plus its rank among the equal lanes below it, and move the
// cursor (the lowest of the equal lanes moves it, so no two lanes write one
// cursor). Slots outside [0, rows) are neither counted nor placed.
template <bool kPlace>
__device__ void walk(const int32_t* __restrict__ ib, int* cnt, int32_t* __restrict__ sb,
                     int lo, int hi, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bits = 32 - __clz(rows);                   // keys lie in [0, rows]
  for (int s0 = lo; s0 < hi; s0 += 32 * kBatch) {     // warp-uniform
    int m[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * 32 + lane;
      m[u] = s < hi ? __ldg(ib + s) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u * 32 >= hi) break;                    // warp-uniform
      const bool ok = m[u] >= 0 && m[u] < rows;
      int* c = cnt + at(static_cast<int64_t>(ok ? m[u] : 0) * kWarps + warp);
      if (!kPlace) {                                   // an integer count: any order
        if (ok) atomicAdd(c, 1);
        continue;
      }
      const unsigned same = peers(ok ? m[u] : rows, bits);
      const int base = ok ? *c : 0;
      if (ok) sb[base + __popc(same & ((1u << lane) - 1u))] = s0 + u * 32 + lane;
      __syncwarp();                                    // every lane read *c
      if (ok && lane == __ffs(same) - 1) *c = base + __popc(same);
      __syncwarp();                                    // *c visible to the next tile
    }
  }
}

__global__ void __launch_bounds__(kThreads)
neighbor_transpose_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ offsets,
                          int32_t* __restrict__ slots, int* __restrict__ scratch,
                          int n, int k, int rows) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int total;
  const int64_t b = blockIdx.x;
  const int nk = n * k;
  const int cells = rows * kWarps;
  const int64_t stride = at(cells) + 1;                // padded cells of one graph
  int* cnt = scratch == nullptr ? smem : scratch + b * stride;      // [rows][kWarps], padded
  const int32_t* ib = idx + b * nk;
  int32_t* ob = offsets + b * (rows + 1);
  int32_t* sb = slots + b * nk;
  const int warp = threadIdx.x >> 5;

  for (int64_t i = threadIdx.x; i < stride; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int seg = ((nk + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = min(nk, warp * seg), hi = min(nk, lo + seg);
  walk<false>(ib, cnt, sb, lo, hi, rows);
  __syncthreads();

  // exclusive scan of cnt in (m, warp) order: each thread a contiguous run
  const int per = (cells + kThreads - 1) / kThreads;
  const int c0 = min(cells, static_cast<int>(threadIdx.x) * per), c1 = min(cells, c0 + per);
  int sum = 0;
  for (int i = c0; i < c1; ++i) sum += cnt[at(i)];
  int run = block_exclusive_scan(sum, warp_sums, &total);
  for (int i = c0; i < c1; ++i) {
    const int v = cnt[at(i)];
    cnt[at(i)] = run;
    run += v;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < rows; m += kThreads)
    ob[m] = cnt[at(static_cast<int64_t>(m) * kWarps)];
  if (threadIdx.x == 0) ob[rows] = total;
  __syncthreads();                                     // offsets read before cursors move

  walk<true>(ib, cnt, sb, lo, hi, rows);
  for (int i = total + threadIdx.x; i < nk; i += kThreads) sb[i] = -1;
}

}  // namespace

// Int32 counters one graph needs (the kernel's padded [M][16] layout).
extern "C" int64_t neighbor_transpose_counters(int64_t rows) { return at(rows * kWarps) + 1; }

// Launches on `stream`, on the caller's current device. idx [B, N, K] over a
// table of `rows` (M) rows; offsets [B, M + 1], slots [B, N * K]. `scratch` is
// null (counters in shared memory) or an int32 buffer of B times
// neighbor_transpose_counters(M) entries, which the kernel zeroes itself.
extern "C" int neighbor_transpose_launch(const void* idx, void* offsets, void* slots,
                                         void* scratch, int64_t batch, int64_t n,
                                         int64_t k, int64_t rows, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = scratch == nullptr
      ? static_cast<size_t>(neighbor_transpose_counters(rows)) * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  neighbor_transpose_kernel<<<static_cast<unsigned>(batch), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(slots), static_cast<int*>(scratch), static_cast<int>(n),
      static_cast<int>(k), static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
