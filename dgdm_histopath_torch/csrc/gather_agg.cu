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
// 3.35 TB/s; its 67 MFLOP are ~1 us at the f32 rate. Design: one warp per
// destination row. Lane k (k < 32) loads idx[k] and w[k] once; the K loop
// broadcasts them with shuffles. Lanes cover F, 4 contiguous features each
// when F % 4 == 0 (one 8-byte bf16 or 16-byte f32 load per lane and term),
// else one feature each. Sums are f32 in registers, in k order. The ~K
// re-reads of each h row (one graph's h is 256 KB) stay in the 50 MB L2.
//
// h is bf16 or f32; w is f32. An index outside [0, N) contributes nothing
// (the zero row of the TPU one-hot kernel). Any N, K and F are taken.
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

template <int V> __device__ void store(float* p, const float* v);
template <> __device__ void store<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ void store<1>(float* p, const float* v) { *p = v[0]; }

template <typename T, int V>
__global__ void gather_agg_kernel(const T* __restrict__ h,
                                  const int32_t* __restrict__ idx,
                                  const float* __restrict__ w,
                                  float* __restrict__ out,
                                  int64_t rows, int64_t n, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp; row < rows; row += warps) {   // warp-uniform loop
    const T* hb = h + (row / n) * n * f;
    const int32_t* ir = idx + row * k;
    const float* wr = w + row * k;
    for (int base = 0; base < f; base += 32 * V) {        // warp-uniform loop
      const int f0 = base + lane * V;
      const bool active = f0 < f;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < k; k0 += 32) {
        const int kk = k0 + lane;
        const int my_j = kk < k ? __ldg(ir + kk) : -1;
        const float my_w = kk < k ? __ldg(wr + kk) : 0.f;
        const int kn = min(32, k - k0);
        for (int s = 0; s < kn; ++s) {
          const int j = __shfl_sync(kFullMask, my_j, s);
          const float ws = __shfl_sync(kFullMask, my_w, s);
          if (active && j >= 0 && j < n) {
            float v[V];
            Load<T, V>::run(hb + static_cast<int64_t>(j) * f + f0, v);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(ws, v[i], acc[i]);
          }
        }
      }
      if (active) store<V>(out + row * f + f0, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const int32_t* idx, const float* w, float* out,
                   int64_t rows, int64_t n, int k, int f, cudaStream_t stream) {
  const int threads = 256;                              // 8 rows per block
  int64_t blocks = (rows * 32 + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;        // grid-stride covers the rest
  const auto* hp = static_cast<const T*>(h);
  const unsigned g = static_cast<unsigned>(blocks);
  if (f % 4 == 0)
    gather_agg_kernel<T, 4><<<g, threads, 0, stream>>>(hp, idx, w, out, rows, n, k, f);
  else
    gather_agg_kernel<T, 1><<<g, threads, 0, stream>>>(hp, idx, w, out, rows, n, k, f);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device.
extern "C" int gather_agg_launch(const void* h, const void* idx, const void* w,
                                 void* out, int64_t batch, int64_t n, int64_t k,
                                 int64_t f, int h_is_bf16, void* stream) {
  cudaError_t err;
  const int64_t rows = batch * n;
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    err = launch<__nv_bfloat16>(h, ix, wp, op, rows, n, static_cast<int>(k),
                                static_cast<int>(f), s);
  else
    err = launch<float>(h, ix, wp, op, rows, n, static_cast<int>(k),
                        static_cast<int>(f), s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
