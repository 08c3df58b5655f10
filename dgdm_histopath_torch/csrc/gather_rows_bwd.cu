// Backward of the neighbor row gather (a scatter-add):
//   dsrc[b, m, :] = sum over (n, k) with idx[b, n, k] == m of g[b, n, k, :]
//
// Replaces dgdm_histopath_tpu/ops/pallas/gather_rows.py::_bwd_kernel. The TPU
// kernel walked node tiles in grid order, built one-hot [128*K, 128] tiles
// and contracted them on the MXU into an [N, F] block that stayed in VMEM.
// On Hopper blocks run in no order and a scatter is a scatter: every (n, k)
// slot adds its row of g into an f32 accumulator with atomics.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 bf16 it must read g
// once (67.1 MB) and idx (1.0 MB) and write dsrc once (8.4 MB): 76.5 MB,
// ~23 us at 3.35 TB/s. This design moves more: it zeroes the f32 accumulator
// (16.8 MB), and for bf16 reads it again and writes the bf16 result
// (16.8 + 8.4 MB). The accumulator of one call fits the 50 MB L2, where the
// atomics resolve. Design: one thread per 4 contiguous features of one
// (n, k) slot (one 8-byte bf16 or 16-byte f32 load, one 16-byte vector
// atomic add), one feature per thread when F % 4 != 0. Sums are f32; a
// second kernel rounds to bf16 once (round to nearest even) when g is bf16.
//
// The order of the atomic adds is not fixed, so the f32 sums are not
// bit-reproducible from run to run. An index outside [0, N) adds nothing
// (the forward gave a zero row there). Any N, K and F are taken.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

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

template <typename T, int V>
__global__ void scatter_rows_kernel(const T* __restrict__ g,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ acc,
                                    int64_t rows, int64_t nk, int64_t n, int64_t f) {
  const int64_t chunks = f / V;
  const int64_t total = rows * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / chunks;                  // flat (b, n, k)
    const int64_t c = t - row * chunks;
    const int64_t j = __ldg(idx + row);
    if (j < 0 || j >= n) continue;
    const int64_t b = row / nk;
    float v[V];
    Load<T, V>::run(g + row * f + c * V, v);
    atomic_add<V>(acc + (b * n + j) * f + c * V, v);
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
  if (blocks > (1LL << 30)) blocks = 1LL << 30;      // grid-stride covers the rest
  return static_cast<unsigned>(blocks);
}

template <typename T>
cudaError_t scatter(const void* g, const int32_t* idx, float* acc, int64_t rows,
                    int64_t nk, int64_t n, int64_t f, cudaStream_t stream) {
  const int threads = 256;
  const auto* gp = static_cast<const T*>(g);
  if (f % 4 == 0)
    scatter_rows_kernel<T, 4><<<grid_for(rows * (f / 4), threads), threads, 0, stream>>>(
        gp, idx, acc, rows, nk, n, f);
  else
    scatter_rows_kernel<T, 1><<<grid_for(rows * f, threads), threads, 0, stream>>>(
        gp, idx, acc, rows, nk, n, f);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device. `acc` is an f32
// [B, N, F] buffer that this call zeroes and sums into; for f32 g it is the
// result. For bf16 g the result is written to `out` (bf16 [B, N, F]).
extern "C" int gather_rows_bwd_launch(const void* g, const void* idx, void* acc,
                                      void* out, int64_t batch, int64_t n, int64_t k,
                                      int64_t f, int g_is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ap = static_cast<float*>(acc);
  const int64_t total = batch * n * f;
  const int64_t rows = batch * n * k;
  if (total == 0) return 0;
  cudaError_t err = cudaMemsetAsync(ap, 0, static_cast<size_t>(total) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const auto* ix = static_cast<const int32_t*>(idx);
    err = g_is_bf16 ? scatter<__nv_bfloat16>(g, ix, ap, rows, n * k, n, f, s)
                    : scatter<float>(g, ix, ap, rows, n * k, n, f, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (g_is_bf16) {
    round_to_bf16_kernel<<<grid_for(total, 256), 256, 0, s>>>(
        ap, static_cast<__nv_bfloat16*>(out), total);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
