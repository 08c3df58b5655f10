// Backward of the weighted neighbor aggregation
//   out[b, n, :] = sum_k w[b, n, k] * h[b, idx[b, n, k], :]
// for the cotangent g [B, N, F] (f32), in one launch:
//   dw[b, n, k]  = sum_f g[b, n, f] * h[b, idx[b, n, k], f]
//   dh[b, m, :]  = sum over s in T(b, m) of w[b, s] * g[b, s / K, :]
// where T(b, m) is the transposed neighbor list (csrc/neighbor_transpose.cu):
// the flat slots s = n*K + k with idx[b, n, k] == m, in increasing order.
// h and dh have the table's M rows: M = N within one graph, M != N for the
// halo tier's sum over a rank's [local || halo] table (parallel/halo.py).
//
// The TPU package has no kernel for this: its backward is XLA
// (dgdm_histopath_tpu/ops/pallas/gather_agg.py::_vjp_bwd, a scatter-add for
// dh and a gathered dot for dw), which forms two f32 [B, N, K, F] tensors.
// This kernel forms neither, and it sums dh as a gather: no atomics, no f32
// accumulator in device memory, no second pass to round it.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 with bf16 h it must
// read g (16.8 MB), h (8.4 MB), idx and w (2.1 MB) and write dh (8.4 MB) and
// dw (1.0 MB): 36.7 MB, ~11 us at 3.35 TB/s; its 134 MFLOP are ~2 us at the
// f32 rate. Each g row is read about K+1 times and each h row about K times;
// one call's g and h (25 MB) fit the 50 MB L2, which serves the re-reads, so
// the ~220 MB that reach the SMs make L2 bandwidth this design's floor.
// Design: a block of 16 half-warps owns 16 consecutive rows of one graph and
// computes one half, dw or dh (the first B*N/16 blocks dw, the rest dh); 16
// lanes cover F with 16-byte loads of h (8 bf16 / f16 or 4 f32 features a lane; one
// feature when rows are not 16-byte aligned). For dw a half-warp keeps its
// slice of g[n, :], loads the K h rows (8 at once), and reduces each dot over
// its 16 lanes with shuffles in a fixed order. For dh it sums w * g over its
// destination row's slots (4 or 8 g rows in flight). A row with more than 32
// slots (pooling sends every dropped neighbor to node 0, ~N*K/2 slots at a
// pooled level) is summed by the whole block after its other rows: each
// half-warp takes a fixed contiguous chunk, the partials go to shared memory
// and are added in half-warp order. dh adds its f32 products w * g in f64,
// so a hub row's thousands of terms are exact to well below f32's rounding,
// and rounds once (through f32) to h's dtype; dw takes each lane's E-term
// f32 dot into an f64 sum over the lanes and the passes over F.
//
// Every sum runs in an order fixed by idx alone, so dh and dw are
// bit-identical from run to run. An index outside [0, M) gives dw = 0 and is
// not in the list, so it adds nothing to dh. Either half can be skipped. Any
// N, M, K and F are taken.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kGroup = 16;                    // lanes per row
constexpr int kGroups = 16;                   // rows per block
constexpr int kThreads = kGroup * kGroups;
constexpr int kShort = 32;                    // a dh row with more slots is summed by the block
constexpr int kInFlight = 8;                  // h rows a half-warp loads at once for dw

// E features of h's type T a lane: E * sizeof(T) == 16 (one vector), or E == 1.
template <typename T, int E> struct HRow;

template <> struct HRow<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static float dot(const float* g, const Raw& r) {
    return fmaf(g[3], r.w, fmaf(g[2], r.z, fmaf(g[1], r.y, g[0] * r.x)));
  }
  __device__ static void store(float* p, const double* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct HRow<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static float dot(const float* g, const Raw& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      d = fmaf(g[2 * i], v.x, d);
      d = fmaf(g[2 * i + 1], v.y, d);
    }
    return d;
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
template <> struct HRow<__half, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __half* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static float dot(const float* g, const Raw& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      d = fmaf(g[2 * i], v.x, d);
      d = fmaf(g[2 * i + 1], v.y, d);
    }
    return d;
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
template <> struct HRow<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return *p; }
  __device__ static float dot(const float* g, const Raw& r) { return g[0] * r; }
  __device__ static void store(float* p, const double* v) { *p = static_cast<float>(v[0]); }
};
template <> struct HRow<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
  __device__ static float dot(const float* g, const Raw& r) {
    return g[0] * __bfloat162float(r);
  }
  __device__ static void store(__nv_bfloat16* p, const double* v) {
    *p = __float2bfloat16_rn(static_cast<float>(v[0]));
  }
};
template <> struct HRow<__half, 1> {
  using Raw = __half;
  __device__ static Raw load(const __half* p) { return *p; }
  __device__ static float dot(const float* g, const Raw& r) { return g[0] * __half2float(r); }
  __device__ static void store(__half* p, const double* v) {
    *p = __float2half_rn(static_cast<float>(v[0]));
  }
};

// E f32 features of g: E / 4 16-byte loads, or one scalar.
template <int E> struct GRow {
  static constexpr int kVecs = E / 4;
  float4 v[kVecs];
  __device__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = reinterpret_cast<const float4*>(p)[i];
  }
  __device__ void to(float* out) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      out[4 * i] = v[i].x; out[4 * i + 1] = v[i].y;
      out[4 * i + 2] = v[i].z; out[4 * i + 3] = v[i].w;
    }
  }
};
template <> struct GRow<1> {
  float v;
  __device__ void load(const float* p) { v = *p; }
  __device__ void to(float* out) const { out[0] = v; }
};

__device__ inline void store_one(float* p, double v) { *p = static_cast<float>(v); }
__device__ inline void store_one(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16_rn(static_cast<float>(v));
}
__device__ inline void store_one(__half* p, double v) {
  *p = __float2half_rn(static_cast<float>(v));
}

// acc[0:E] = f64 sum of the f32 products w[s] * g[s / k] over the slots
// s = sl[j], j in [j0, j1), in j order, at features [fl, fl + E) (zeros when
// `act` is false).
template <int E>
__device__ void sum_weighted(const float* __restrict__ gb, const float* __restrict__ wb,
                             const int32_t* __restrict__ sl, int j0, int j1, int k, int f,
                             int fl, bool act, double* acc) {
  constexpr int kIn = E == 8 ? 4 : 8;          // g rows in flight: 32 registers of loads
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0;
  if (!act) return;
  for (int j = j0; j < j1; j += kIn) {
    int s[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) s[u] = j + u < j1 ? __ldg(sl + j + u) : -1;
    GRow<E> rows[kIn];
    float ws[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      if (s[u] >= 0) {
        ws[u] = __ldg(wb + s[u]);
        rows[u].load(gb + static_cast<int64_t>(s[u] / k) * f + fl);
      }
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      if (s[u] >= 0) {
        float gv[E];
        rows[u].to(gv);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += __fmul_rn(ws[u], gv[e]);
      }
    }
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
gather_agg_bwd_kernel(const float* __restrict__ g, const T* __restrict__ h,
                      const int32_t* __restrict__ idx, const float* __restrict__ w,
                      const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                      T* __restrict__ dh, float* __restrict__ dw,
                      int n, int rows, int k, int f, int tiles, int row_tiles,
                      int dw_blocks) {
  constexpr int kSpan = kGroup * E;            // features a half-warp covers per pass
  using H = HRow<T, E>;
  __shared__ double part[kGroups][kSpan];
  __shared__ int row_start[kGroups], row_count[kGroups];
  // blocks [0, dw_blocks) compute dw, each over a tile of the N rows, the
  // rest dh, each over a tile of the M table rows
  const bool dw_half = static_cast<int>(blockIdx.x) < dw_blocks;
  const int tile = dw_half ? blockIdx.x : blockIdx.x - dw_blocks;
  const int per_graph = dw_half ? tiles : row_tiles;
  const int64_t b = tile / per_graph;
  const int r0 = (tile % per_graph) * kGroups;
  const int grp = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int64_t nk = static_cast<int64_t>(n) * k;
  const float* gb = g + b * n * f;
  const int row = r0 + grp;

  if (dw_half) {
    if (row >= n) return;
    const unsigned half = 0xffffu << (threadIdx.x & 16);
    const T* hb = h + b * rows * f;
    const int32_t* ir = idx + (b * n + row) * k;
    const float* gr = gb + static_cast<int64_t>(row) * f;
    for (int k0 = 0; k0 < k; k0 += kInFlight) {
      int j[kInFlight];
      double dot[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        j[u] = k0 + u < k ? __ldg(ir + k0 + u) : -1;
        if (j[u] >= rows) j[u] = -1;
        dot[u] = 0.0;
      }
      for (int f0 = 0; f0 < f; f0 += kSpan) {
        const int fl = f0 + lane * E;
        if (fl < f) {
          GRow<E> gl;
          gl.load(gr + fl);
          typename H::Raw raw[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (j[u] >= 0) raw[u] = H::load(hb + static_cast<int64_t>(j[u]) * f + fl);
          float gv[E];
          gl.to(gv);
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (j[u] >= 0) dot[u] += H::dot(gv, raw[u]);    // a lane's E terms in f32
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
          dot[u] += __shfl_xor_sync(half, dot[u], o, kGroup);
        if (lane == u && k0 + u < k)
          dw[(b * n + row) * k + k0 + u] = static_cast<float>(dot[u]);
      }
    }
    return;
  }

  const int32_t* off = offsets + b * (rows + 1);
  const int32_t* sl = slots + b * nk;
  const float* wb = w + b * nk;
  T* ob = dh + b * rows * f;
  const int start = row < rows ? __ldg(off + row) : 0;
  const int count = row < rows ? __ldg(off + row + 1) - start : 0;
  if (lane == 0) {
    row_start[grp] = start;
    row_count[grp] = count;
  }
  if (row < rows && count <= kShort) {
    for (int f0 = 0; f0 < f; f0 += kSpan) {
      const int fl = f0 + lane * E;
      double acc[E];
      sum_weighted<E>(gb, wb, sl, start, start + count, k, f, fl, fl < f, acc);
      if (fl < f) H::store(ob + static_cast<int64_t>(row) * f + fl, acc);
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
      sum_weighted<E>(gb, wb, sl, j0, j1, k, f, fl, fl < f, acc);
#pragma unroll
      for (int e = 0; e < E; ++e) part[grp][lane * E + e] = acc[e];
      __syncthreads();
      for (int t = threadIdx.x; t < kSpan; t += kThreads) {
        if (f0 + t < f) {
          double s = 0.0;
          for (int q = 0; q < kGroups; ++q) s += part[q][t];
          store_one(ob + static_cast<int64_t>(r0 + r) * f + f0 + t, s);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int E>
cudaError_t launch(const float* g, const void* h, const int32_t* idx, const float* w,
                   const int32_t* off, const int32_t* sl, void* dh, float* dw,
                   int64_t batch, int64_t n, int64_t k, int64_t f, int64_t rows,
                   cudaStream_t s) {
  const int64_t tiles = (n + kGroups - 1) / kGroups;
  const int64_t row_tiles = (rows + kGroups - 1) / kGroups;
  const int64_t dw_blocks = dw == nullptr ? 0 : batch * tiles;
  const int64_t blocks = dw_blocks + (dh == nullptr ? 0 : batch * row_tiles);
  if (blocks == 0) return cudaSuccess;
  gather_agg_bwd_kernel<T, E><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      g, static_cast<const T*>(h), idx, w, off, sl, static_cast<T*>(dh), dw,
      static_cast<int>(n), static_cast<int>(rows), static_cast<int>(k),
      static_cast<int>(f), static_cast<int>(tiles), static_cast<int>(row_tiles),
      static_cast<int>(dw_blocks));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device. g [B, N, F] f32, h
// [B, M, F] (M = `rows`) in `dtype` (0 f32, 1 bf16, 2 f16), idx [B, N, K]
// int32, w [B, N, K] f32; offsets [B, M + 1] and slots [B, N*K] from
// neighbor_transpose over M rows (read only for dh). dh [B, M, F] in h's
// dtype (null: not wanted; a sum beyond the dtype's range is written as
// +-inf, as the reference's f32 sum cast to h's dtype is), dw [B, N, K] f32
// (null: not wanted). `vec`: rows are 16-byte aligned (F times h's element size a
// multiple of 16, base pointers aligned).
extern "C" int gather_agg_bwd_launch(const void* g, const void* h, const void* idx,
                                     const void* w, const void* offsets, const void* slots,
                                     void* dh, void* dw, int64_t batch, int64_t n,
                                     int64_t k, int64_t f, int64_t rows, int dtype, int vec,
                                     void* stream) {
  if (dh == nullptr && dw == nullptr) return 0;
  if (dh == nullptr && (k == 0 || f == 0)) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* wp = static_cast<const float*>(w);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* dwp = static_cast<float*>(dw);
  cudaError_t err;
  if (dtype == 1)
    err = vec ? launch<__nv_bfloat16, 8>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f,
                                         rows, s)
              : launch<__nv_bfloat16, 1>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f,
                                         rows, s);
  else if (dtype == 2)
    err = vec ? launch<__half, 8>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f, rows, s)
              : launch<__half, 1>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f, rows, s);
  else if (dtype == 0)
    err = vec ? launch<float, 4>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f, rows, s)
              : launch<float, 1>(gp, h, ix, wp, off, sl, dh, dwp, batch, n, k, f, rows, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
