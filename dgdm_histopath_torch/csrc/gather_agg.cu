// Weighted neighbor aggregation:
//   out[b, n, :] = sum_k w[b, n, k] * h[b, idx[b, n, k], :]   (f32 out)
//
// Replaces dgdm_histopath_tpu/ops/pallas/gather_agg.py::_kernel (the message
// sum of each GraphConvolution, two per DynamicGraphLayer). The TPU kernel
// kept h in VMEM and summed one-hot [128 x 128] tiles on the MXU; on Hopper
// the gather is direct and the K-term sum runs in registers.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 with bf16 h it reads
// h (8.4 MB), idx and w (2 MB) and writes f32 out (16.8 MB): ~27 MB, ~8 us at
// 3.35 TB/s; its 67 MFLOP are ~1 us at the f32 rate.
//
// Design. What held the first design back (its SASS): a warp per row walked
// the K slots in a loop of shuffle, bounds branch, one 8-byte load and the
// FMAs that consume it, so each row waited for K dependent round trips to
// L2. Here a group of G lanes (a power of two, G * V >= F where it can be)
// serves one row; at F = 128 bf16 a half-warp. Every lane of the group reads
// the row's indices and weights itself (one broadcast load, as two 16-byte
// loads each when K = 8, the only K of the presets, compiled apart for
// 16-byte lanes), then issues the h loads of kChunk slots before the first
// FMA: a row costs one round trip for idx / w and one for h per kChunk
// slots. The h loads carry no condition (an index out of range reads row 0
// and is zeroed after): a conditional load is sunk by the compiler next to
// its FMAs, one in flight again. h is read through the read-only path, 16
// bytes a lane (8 bf16 / f16 or 4 f32) where rows and pointer are 16-byte aligned,
// else one element a lane.
// Sums are f32 in registers, in k order. out leaves as 16-byte streaming
// stores (st.global.cs): written once and never read here, it should not
// push h out of L2. Rows run in order through the grid, so one graph's h
// (256 KB at N 1024 bf16) is read again from the 50 MB L2 by its ~K readers.
//
// What binds it then: those K-fold reads of h from L2 (8 x 8.4 MB a call at
// the shape above, against the 27 MB the byte bound counts), not DRAM. A
// launch-shape sweep on the card (H100 80GB HBM3, 700 W) measured 128, 256
// and 512 threads a block, 8-byte against 16-byte bf16 loads and three store
// policies; this file keeps the best: 256 threads, 16 bytes, streaming. The
// any-K path at K = 8 took 22-33% longer than the K = 8 path at every level
// shape of the two presets (PERF.md), so K = 8 keeps its own; one-element
// lanes serve only inputs off 16-byte alignment and take the any-K path.
//
// h is bf16, f16 or f32 (an f16 lane converts its halves as a bf16 lane
// does, exactly, to f32); w is f32. An index outside [0, N_src) contributes
// nothing (the zero row of the TPU one-hot kernel): its loaded values and its
// weight are taken as 0. Any N, K and F are taken.
//
// h may hold another row count than the query: h [B, N_src, F], idx and w
// [B, N, K]. The node-sharded (halo) tier sums a rank's N local rows over
// its [local || halo] table of N_src = N + tp*H rows; the model's own
// aggregations are square (N_src = N).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;          // slots whose h loads are in flight at once

// element i of bf16 pairs packed in 32-bit words, as f32 (a shift or a mask)
__device__ __forceinline__ float bf16_word(const unsigned* words, int i) {
  const unsigned word = words[i >> 1];
  return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
}

// V elements of T that one lane loads at once (16 bytes, or one element);
// Raw holds them as loaded
template <typename T, int V> struct Lane;

template <> struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static float get(const Raw& r, int i) { return bf16_word(&r.x, i); }
};
template <> struct Lane<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return __ldg(p); }
  __device__ static float get(const Raw& r, int) { return __bfloat162float(r); }
};
template <> struct Lane<__half, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __half* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static float get(const Raw& r, int i) {
    const unsigned word = (&r.x)[i >> 1];
    return __half2float(__ushort_as_half(static_cast<unsigned short>(
        (i & 1) ? (word >> 16) : (word & 0xffffu))));
  }
};
template <> struct Lane<__half, 1> {
  using Raw = __half;
  __device__ static Raw load(const __half* p) { return __ldg(p); }
  __device__ static float get(const Raw& r, int) { return __half2float(r); }
};
template <> struct Lane<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static float get(const Raw& r, int i) { return (&r.x)[i]; }
};
template <> struct Lane<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static float get(const Raw& r, int) { return r; }
};

template <int V> __device__ void store(float* p, const float* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

// The slots k0 .. k0 + kChunk - 1 of one row: index (-1 past K) and weight.
// KC = 8 reads them as 16-byte vectors (the launcher checks the alignment).
template <int KC>
__device__ void load_slots(const int32_t* ir, const float* wr, int k0, int k,
                           int* j, float* ws) {
  if constexpr (KC == kChunk) {
    const int4 i0 = __ldg(reinterpret_cast<const int4*>(ir));
    const int4 i1 = __ldg(reinterpret_cast<const int4*>(ir) + 1);
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wr));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wr) + 1);
    j[0] = i0.x; j[1] = i0.y; j[2] = i0.z; j[3] = i0.w;
    j[4] = i1.x; j[5] = i1.y; j[6] = i1.z; j[7] = i1.w;
    ws[0] = w0.x; ws[1] = w0.y; ws[2] = w0.z; ws[3] = w0.w;
    ws[4] = w1.x; ws[5] = w1.y; ws[6] = w1.z; ws[7] = w1.w;
  } else {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool in = k0 + s < k;
      j[s] = in ? __ldg(ir + k0 + s) : -1;
      ws[s] = in ? __ldg(wr + k0 + s) : 0.f;
    }
  }
}

// V: elements of h a lane loads at once. KC: K fixed at compile time (8),
// or 0 for any K in chunks of kChunk. lane_bits: log2 of the lanes G that
// serve one row. The launch bounds ask for one block an SM at least: left to
// itself, ptxas held the any-K bf16 kernel to 48 registers and spilled.
template <typename T, int V, int KC>
__global__ void __launch_bounds__(kThreads, 1)
gather_agg_kernel(const T* __restrict__ h, const int32_t* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ out,
                  int rows, int n, int n_src, int k_runtime, int f, int lane_bits) {
  using L = Lane<T, V>;
  const int k = KC > 0 ? KC : k_runtime;
  const int sub = threadIdx.x & ((1 << lane_bits) - 1);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> lane_bits;
  const int span = V << lane_bits;                     // features one pass covers
  for (int64_t row = tid >> lane_bits; row < rows; row += groups) {
    // a 32-bit division (B * N < 2^31): the 64-bit one is a subroutine call
    const int graph = static_cast<int>(row) / n;
    const T* hb = h + static_cast<int64_t>(graph) * n_src * f;
    const int32_t* ir = idx + row * k;
    const float* wr = w + row * k;
    for (int f0 = sub * V; f0 < f; f0 += span) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < k; k0 += kChunk) {
        int j[kChunk];
        float ws[kChunk];
        load_slots<KC>(ir, wr, k0, k, j, ws);
        // every load before any FMA: loads without a condition (an index out
        // of range reads row 0 and is zeroed after), so that the compiler
        // does not sink each into a branch next to its FMAs
        typename L::Raw raw[kChunk];
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          const bool ok = static_cast<unsigned>(j[s]) < static_cast<unsigned>(n_src);
          raw[s] = L::load(hb + static_cast<int64_t>(ok ? j[s] : 0) * f + f0);
        }
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {             // k order
          if (static_cast<unsigned>(j[s]) >= static_cast<unsigned>(n_src)) {
            raw[s] = typename L::Raw{};                // contributes nothing
            ws[s] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(ws[s], L::get(raw[s], i), acc[i]);
        }
      }
      store<V>(out + row * f + f0, acc);
    }
  }
}

template <typename T, int V, int KC>
cudaError_t launch(const void* h, const int32_t* idx, const float* w, float* out,
                   int64_t rows, int64_t n, int64_t n_src, int k, int f, cudaStream_t stream) {
  int lane_bits = 0;                                   // G = 2^lane_bits lanes a row
  while (lane_bits < 5 && (V << lane_bits) < f) ++lane_bits;
  const int64_t rows_per_block = kThreads >> lane_bits;
  int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;        // grid-stride covers the rest
  gather_agg_kernel<T, V, KC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(h), idx, w, out, static_cast<int>(rows), static_cast<int>(n),
      static_cast<int>(n_src), k, f, lane_bits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// V = 16 bytes of h a lane where h's rows start on 16 bytes, else 1 (and
// then any K); the K = 8 path where idx and w start on 16 bytes too
template <typename T>
cudaError_t launch_dtype(const void* h, const int32_t* idx, const float* w, float* out,
                         int64_t rows, int64_t n, int64_t n_src, int k, int f,
                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!(aligned16(h) && f % V == 0))
    return launch<T, 1, 0>(h, idx, w, out, rows, n, n_src, k, f, stream);
  if (k == kChunk && aligned16(idx) && aligned16(w))
    return launch<T, V, kChunk>(h, idx, w, out, rows, n, n_src, k, f, stream);
  return launch<T, V, 0>(h, idx, w, out, rows, n, n_src, k, f, stream);
}

}  // namespace

// Launches on `stream`, on the caller's current device. `out` is a fresh
// contiguous f32 tensor (16-byte aligned rows wherever h's are). h holds
// n_src rows a graph in `dtype` (0 f32, 1 bf16, 2 f16), idx and w n rows of
// k slots. B * N, N_src, K and F must be below 2^31 (the wrapper checks).
extern "C" int gather_agg_launch(const void* h, const void* idx, const void* w,
                                 void* out, int64_t batch, int64_t n, int64_t k,
                                 int64_t n_src, int64_t f, int dtype, void* stream) {
  const int64_t rows = batch * n;
  if (rows >= (1LL << 31) || n_src >= (1LL << 31) || k >= (1LL << 31) || f >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int ki = static_cast<int>(k), fi = static_cast<int>(f);
  cudaError_t err;
  if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(h, ix, wp, op, rows, n, n_src, ki, fi, s);
  else if (dtype == 2)
    err = launch_dtype<__half>(h, ix, wp, op, rows, n, n_src, ki, fi, s);
  else if (dtype == 0)
    err = launch_dtype<float>(h, ix, wp, op, rows, n, n_src, ki, fi, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
