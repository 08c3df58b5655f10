// Backward of the neighbor row gather, as a gather-sum over the transposed
// neighbor list (csrc/neighbor_transpose.cu):
//   dsrc[b, m, :] = sum over s in T(b, m) of g[b, s, :]
// where g is [B, N*K, F] (the forward's [B, N, K, F]) and T(b, m) the slots
// s = n*K + k with idx[b, n, k] == m, in increasing order.
//
// Replaces dgdm_histopath_tpu/ops/pallas/gather_rows.py::_bwd_kernel. The TPU
// kernel walked node tiles in grid order, built one-hot [128*K, 128] tiles
// and contracted them on the MXU into an [N, F] block that stayed in VMEM.
// On Hopper blocks run in no order, so each destination row gathers and sums
// its own slots: no atomics, no f32 accumulator in device memory, no second
// pass to round it.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 bf16 it must read g
// once (67.1 MB) and idx (1.0 MB) and write dsrc once (8.4 MB): 76.5 MB,
// ~23 us at 3.35 TB/s. This design reads g once, the list (~1.2 MB) and
// writes dsrc once. Design: a block of 16 half-warps owns 16 consecutive
// destination rows of one graph, two blocks an SM. A half-warp sums one row:
// 16 lanes cover F with 16-byte loads (8 bf16 / f16 or 4 f32 features a lane; one
// feature when the rows are not 16-byte aligned), and it loads up to 8 slots'
// rows at once. A row with more than 32 slots (pooling sends every dropped
// neighbor to node 0, ~N*K/2 slots at a pooled level) is summed by the whole
// block after its other rows: each half-warp takes a fixed contiguous chunk
// (16 rows in flight), the partials go to shared memory and are added in
// half-warp order. Such a row sets the time of a pooled level: one block's
// chain of ~N*K/32/16 round trips to memory. Sums are f64 in
// registers (an add costs nothing here: the loads bound the kernel), so a
// sum of thousands of f32 terms is exact to well below f32's rounding and
// its f32, bf16 or f16 result, rounded once (through f32), hardly depends on the
// order; with f32 sums a hub row's result moved by 1e-4 between orders.
//
// Every sum runs in an order fixed by idx alone, so the result is
// bit-identical from run to run. Out-of-range indices are not in the list
// and add nothing (the forward gave a zero row there). Any N, K and F.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kGroup = 16;                    // lanes per destination row
constexpr int kGroups = 16;                   // rows per block
constexpr int kThreads = kGroup * kGroups;
constexpr int kShort = 32;                    // a row with more slots is summed by the block
constexpr int kInFlight = 8;                  // g rows a half-warp loads at once
constexpr int kInFlightLong = 16;             // the same in a long row's chunks

// E features of T a lane: E * sizeof(T) == 16 (one vector), or E == 1.
template <typename T, int E> struct Row;

template <> struct Row<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void add(double* acc, const Raw& r) {
    acc[0] += r.x; acc[1] += r.y; acc[2] += r.z; acc[3] += r.w;
  }
  __device__ static void store(float* p, const double* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void add(double* acc, const Raw& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      acc[2 * i] += v.x;
      acc[2 * i + 1] += v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const double* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // f64 -> f32 -> bf16, as the plain version rounds
      const __nv_bfloat162 x = __floats2bfloat162_rn(static_cast<float>(v[2 * i]),
                                                     static_cast<float>(v[2 * i + 1]));
      w[i] = *reinterpret_cast<const uint32_t*>(&x);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Row<__half, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __half* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void add(double* acc, const Raw& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      acc[2 * i] += v.x;
      acc[2 * i + 1] += v.y;
    }
  }
  __device__ static void store(__half* p, const double* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // f64 -> f32 -> f16, as the plain version rounds
      const __half2 x = __floats2half2_rn(static_cast<float>(v[2 * i]),
                                          static_cast<float>(v[2 * i + 1]));
      w[i] = *reinterpret_cast<const uint32_t*>(&x);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Row<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return *p; }
  __device__ static void add(double* acc, const Raw& r) { acc[0] += r; }
  __device__ static void store(float* p, const double* v) { *p = static_cast<float>(v[0]); }
};
template <> struct Row<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
  __device__ static void add(double* acc, const Raw& r) { acc[0] += __bfloat162float(r); }
  __device__ static void store(__nv_bfloat16* p, const double* v) {
    *p = __float2bfloat16_rn(static_cast<float>(v[0]));
  }
};
template <> struct Row<__half, 1> {
  using Raw = __half;
  __device__ static Raw load(const __half* p) { return *p; }
  __device__ static void add(double* acc, const Raw& r) { acc[0] += __half2float(r); }
  __device__ static void store(__half* p, const double* v) {
    *p = __float2half_rn(static_cast<float>(v[0]));
  }
};

__device__ inline void store_one(float* p, double v) { *p = static_cast<float>(v); }
__device__ inline void store_one(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16_rn(static_cast<float>(v));
}
__device__ inline void store_one(__half* p, double v) {
  *p = __float2half_rn(static_cast<float>(v));
}

// acc[0:E] = f64 sum of g rows sl[j], j in [j0, j1), in j order, at features
// [fl, fl + E) (the lane is idle when `act` is false and returns zeros).
template <typename T, int E, int kIn>
__device__ void sum_slots(const T* __restrict__ gb, const int32_t* __restrict__ sl,
                          int j0, int j1, int f, int fl, bool act, double* acc) {
  using R = Row<T, E>;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0;
  if (!act) return;
  for (int j = j0; j < j1; j += kIn) {
    int s[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) s[u] = j + u < j1 ? __ldg(sl + j + u) : -1;
    typename R::Raw raw[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u)
      if (s[u] >= 0) raw[u] = R::load(gb + static_cast<int64_t>(s[u]) * f + fl);
#pragma unroll
    for (int u = 0; u < kIn; ++u)
      if (s[u] >= 0) R::add(acc, raw[u]);
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
gather_rows_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ slots, T* __restrict__ out,
                       int n, int nk, int f, int tiles) {
  constexpr int kSpan = kGroup * E;            // features a half-warp covers per pass
  __shared__ double part[kGroups][kSpan];
  __shared__ int row_start[kGroups], row_count[kGroups];
  const int64_t b = blockIdx.x / tiles;
  const int r0 = static_cast<int>(blockIdx.x % tiles) * kGroups;
  const int grp = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int32_t* off = offsets + b * (n + 1);
  const int32_t* sl = slots + b * nk;
  const T* gb = g + b * nk * f;
  T* ob = out + b * n * f;

  const int row = r0 + grp;
  const int start = row < n ? __ldg(off + row) : 0;
  const int count = row < n ? __ldg(off + row + 1) - start : 0;
  if (lane == 0) {
    row_start[grp] = start;
    row_count[grp] = count;
  }
  if (row < n && count <= kShort) {
    for (int f0 = 0; f0 < f; f0 += kSpan) {
      const int fl = f0 + lane * E;
      double acc[E];
      sum_slots<T, E, kInFlight>(gb, sl, start, start + count, f, fl, fl < f, acc);
      if (fl < f) Row<T, E>::store(ob + static_cast<int64_t>(row) * f + fl, acc);
    }
  }
  __syncthreads();

  // long rows: the whole block, fixed chunks, partials added in chunk order
  for (int r = 0; r < kGroups; ++r) {
    const int c = row_count[r];
    if (c <= kShort) continue;                 // block-uniform
    const int per = (c + kGroups - 1) / kGroups;
    const int j0 = row_start[r] + min(c, grp * per);
    const int j1 = row_start[r] + min(c, grp * per + per);
    for (int f0 = 0; f0 < f; f0 += kSpan) {
      const int fl = f0 + lane * E;
      double acc[E];
      sum_slots<T, E, kInFlightLong>(gb, sl, j0, j1, f, fl, fl < f, acc);
#pragma unroll
      for (int e = 0; e < E; ++e) part[grp][lane * E + e] = acc[e];
      __syncthreads();
      for (int t = threadIdx.x; t < kSpan; t += kThreads) {
        if (f0 + t < f) {
          double s = 0.0;
          for (int h = 0; h < kGroups; ++h) s += part[h][t];
          store_one(ob + static_cast<int64_t>(r0 + r) * f + f0 + t, s);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int E>
cudaError_t launch(const void* g, const int32_t* off, const int32_t* sl, void* out,
                   int64_t batch, int64_t n, int64_t k, int64_t f, cudaStream_t s) {
  const int64_t tiles = (n + kGroups - 1) / kGroups;
  gather_rows_bwd_kernel<T, E><<<static_cast<unsigned>(batch * tiles), kThreads, 0, s>>>(
      static_cast<const T*>(g), off, sl, static_cast<T*>(out), static_cast<int>(n),
      static_cast<int>(n * k), static_cast<int>(f), static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device. g [B, N*K, F] and
// out [B, N, F] in one dtype (`dtype`: 0 f32, 1 bf16, 2 f16), offsets
// [B, N + 1] and slots [B, N*K] from neighbor_transpose. `vec`: rows are
// 16-byte aligned (F times the element size a multiple of 16, base pointers
// aligned). A sum beyond the largest finite value of the dtype is written as
// +-inf (f16 saturates at 65504), as the f32 sums of the TPU kernel, cast to
// g's dtype, are.
extern "C" int gather_rows_bwd_launch(const void* g, const void* offsets, const void* slots,
                                      void* out, int64_t batch, int64_t n, int64_t k,
                                      int64_t f, int dtype, int vec, void* stream) {
  if (batch * n * f == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* sl = static_cast<const int32_t*>(slots);
  cudaError_t err;
  if (dtype == 1)
    err = vec ? launch<__nv_bfloat16, 8>(g, off, sl, out, batch, n, k, f, s)
              : launch<__nv_bfloat16, 1>(g, off, sl, out, batch, n, k, f, s);
  else if (dtype == 2)
    err = vec ? launch<__half, 8>(g, off, sl, out, batch, n, k, f, s)
              : launch<__half, 1>(g, off, sl, out, batch, n, k, f, s);
  else if (dtype == 0)
    err = vec ? launch<float, 4>(g, off, sl, out, batch, n, k, f, s)
              : launch<float, 1>(g, off, sl, out, batch, n, k, f, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
