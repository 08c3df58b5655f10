// Backward of the weighted neighbor aggregation
//   out[b, n, :] = sum_k w[b, n, k] * h[b, idx[b, n, k], :]
// for the cotangent g [B, N, F] (f32):
//   dh[b, m, :]  = sum over (n, k) with idx[b, n, k] == m of w[b, n, k] * g[b, n, :]
//   dw[b, n, k]  = sum_f g[b, n, f] * h[b, idx[b, n, k], f]
//
// The TPU package has no kernel for this: its backward is XLA
// (dgdm_histopath_tpu/ops/pallas/gather_agg.py::_vjp_bwd, a scatter-add for
// dh and a gathered dot for dw), which forms two f32 [B, N, K, F] tensors.
// This kernel forms neither.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 with bf16 h it must
// read g (16.8 MB), h (8.4 MB), idx and w (2.1 MB) and write dh (8.4 MB) and
// dw (1.0 MB): 36.7 MB, ~11 us at 3.35 TB/s; its 134 MFLOP are ~2 us at the
// f32 rate. This design also zeroes the f32 dh accumulator (16.8 MB) and,
// for bf16 h, reads it again to round it. Design: the forward's layout, one
// warp per destination row n, lanes over F (4 contiguous features each when
// F % 4 == 0). The warp keeps its slice of g[n, :] in registers; per
// neighbor slot it loads the h row, reduces the dot with shuffles into dw,
// and adds w * g into the f32 dh accumulator with one 16-byte vector atomic
// per lane. Lane k holds idx[k], w[k] and dw[k], so those are loaded and
// stored coalesced. A second kernel rounds dh to bf16 once when h is bf16.
//
// The order of the atomic adds is not fixed, so dh is not bit-reproducible
// from run to run; dw is. An index outside [0, N) gives dw = 0 and adds
// nothing to dh. Either half can be skipped. Any N, K and F are taken.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int V> struct Load;

template <> struct Load<float, 4> {
  __device__ static void run(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Load<__nv_bfloat16, 4> {
  __device__ static void run(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};
template <> struct Load<float, 1> {
  __device__ static void run(const float* p, float* v) { v[0] = *p; }
};
template <> struct Load<__nv_bfloat16, 1> {
  __device__ static void run(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
};

template <int V> __device__ void atomic_add(float* p, const float* v);
template <> __device__ void atomic_add<4>(float* p, const float* v) {
#if CUDART_VERSION >= 12020
  // sm_90 vector atomic: one 16-byte reduction, each element atomic
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
#else
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(p + i, v[i]);
#endif
}
template <> __device__ void atomic_add<1>(float* p, const float* v) { atomicAdd(p, v[0]); }

// acc is null when dh is not wanted, dw is null when dw is not wanted.
template <typename T, int V>
__global__ void gather_agg_bwd_kernel(const float* __restrict__ g,
                                      const T* __restrict__ h,
                                      const int32_t* __restrict__ idx,
                                      const float* __restrict__ w,
                                      float* __restrict__ acc,
                                      float* __restrict__ dw,
                                      int64_t rows, int64_t n, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp; row < rows; row += warps) {   // warp-uniform loop
    const int64_t b = row / n;
    const T* hb = h + b * n * f;
    float* ab = acc == nullptr ? nullptr : acc + b * n * f;
    const float* gr = g + row * f;
    const int32_t* ir = idx + row * k;
    const float* wr = w + row * k;
    float g0[V];                                          // g[n, lane's first chunk]
#pragma unroll
    for (int i = 0; i < V; ++i) g0[i] = 0.f;
    if (lane * V < f) Load<float, V>::run(gr + lane * V, g0);
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int kk = k0 + lane;
      const int my_j = kk < k ? __ldg(ir + kk) : -1;
      const float my_w = kk < k ? __ldg(wr + kk) : 0.f;
      float my_dw = 0.f;
      const int kn = min(32, k - k0);
      for (int s = 0; s < kn; ++s) {
        const int j = __shfl_sync(kFullMask, my_j, s);
        const float ws = __shfl_sync(kFullMask, my_w, s);
        if (j < 0 || j >= n) continue;                    // warp-uniform
        float dot = 0.f;
        for (int base = 0; base < f; base += 32 * V) {    // warp-uniform loop
          const int f0 = base + lane * V;
          if (f0 < f) {
            float gv[V];
            if (base == 0) {
#pragma unroll
              for (int i = 0; i < V; ++i) gv[i] = g0[i];
            } else {
              Load<float, V>::run(gr + f0, gv);
            }
            if (dw != nullptr) {
              float hv[V];
              Load<T, V>::run(hb + static_cast<int64_t>(j) * f + f0, hv);
#pragma unroll
              for (int i = 0; i < V; ++i) dot = fmaf(gv[i], hv[i], dot);
            }
            if (ab != nullptr) {
              float c[V];
#pragma unroll
              for (int i = 0; i < V; ++i) c[i] = ws * gv[i];
              atomic_add<V>(ab + static_cast<int64_t>(j) * f + f0, c);
            }
          }
        }
        if (dw != nullptr) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFullMask, dot, off);
          if (lane == s) my_dw = dot;
        }
      }
      if (dw != nullptr && kk < k) dw[row * k + kk] = my_dw;
    }
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ acc,
                                     __nv_bfloat16* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride)
    out[t] = __float2bfloat16_rn(acc[t]);
}

unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;          // grid-stride covers the rest
  return static_cast<unsigned>(blocks);
}

template <typename T>
cudaError_t launch(const float* g, const void* h, const int32_t* idx, const float* w,
                   float* acc, float* dw, int64_t rows, int64_t n, int k, int f,
                   cudaStream_t stream) {
  const int threads = 256;                                // 8 rows per block
  const unsigned grid = grid_for(rows * 32, threads);
  const auto* hp = static_cast<const T*>(h);
  if (f % 4 == 0)
    gather_agg_bwd_kernel<T, 4><<<grid, threads, 0, stream>>>(g, hp, idx, w, acc, dw,
                                                              rows, n, k, f);
  else
    gather_agg_bwd_kernel<T, 1><<<grid, threads, 0, stream>>>(g, hp, idx, w, acc, dw,
                                                              rows, n, k, f);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device. `acc` is an f32
// [B, N, F] buffer that this call zeroes and sums dh into (null: dh is not
// wanted); for f32 h it is dh, for bf16 h dh is written to `dh_out`. `dw` is
// f32 [B, N, K] (null: dw is not wanted).
extern "C" int gather_agg_bwd_launch(const void* g, const void* h, const void* idx,
                                     const void* w, void* acc, void* dh_out, void* dw,
                                     int64_t batch, int64_t n, int64_t k, int64_t f,
                                     int h_is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ap = static_cast<float*>(acc);
  auto* dwp = static_cast<float*>(dw);
  const int64_t rows = batch * n;
  const int64_t total = rows * f;
  cudaError_t err = cudaSuccess;
  if (ap != nullptr && total > 0) {
    err = cudaMemsetAsync(ap, 0, static_cast<size_t>(total) * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows > 0 && k > 0 && (ap != nullptr || dwp != nullptr)) {
    const auto* gp = static_cast<const float*>(g);
    const auto* ix = static_cast<const int32_t*>(idx);
    const auto* wp = static_cast<const float*>(w);
    err = h_is_bf16
        ? launch<__nv_bfloat16>(gp, h, ix, wp, ap, dwp, rows, n, static_cast<int>(k),
                                static_cast<int>(f), s)
        : launch<float>(gp, h, ix, wp, ap, dwp, rows, n, static_cast<int>(k),
                        static_cast<int>(f), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ap != nullptr && h_is_bf16 && total > 0) {
    round_to_bf16_kernel<<<grid_for(total, 256), 256, 0, s>>>(
        ap, static_cast<__nv_bfloat16*>(dh_out), total);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
