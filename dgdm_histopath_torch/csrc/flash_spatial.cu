// Flash spatial attention: masked softmax attention over the nodes of a graph
// with the distance bias -|p_i - p_j| / tau, without any [N, N] array in
// device memory.
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:].k[b,j,h,:]
//                                     - |pos[b,i] - pos[b,j]| / tau) * v[b,j,h,:]
//   over the keys j with node_mask[b, j]; a graph without a valid key gives 0.
//
// Two kernels, replacing the two TPU kernels of
// dgdm_histopath_tpu/ops/pallas/flash_spatial.py:
//   flash_spatial_packed_kernel     <- _flash_kernel_packed (:101): H * D = 128.
//     One block owns a tile of query rows of one graph for ALL heads; the
//     bias of a (query tile, key tile) pair is computed once and used by
//     every head.
//   flash_spatial_headmajor_kernel  <- _flash_kernel (:47): any H and D <= 256.
//     One block owns a tile of query rows of one (graph, head) pair and reads
//     q, k, v in place from the [B, N, H, D] layout with the true D (no
//     transposed or padded copy in device memory).
//
// What was redesigned against the TPU kernels. The TPU grid walks the key
// blocks in order and carries the running max m, the denominator l and the
// accumulator in scratch memory between grid steps; thread blocks on Hopper
// run in no order, so here each block loops over the key tiles itself and a
// thread keeps m, l and its slice of the accumulator in registers. The TPU's
// 128-lane devices (pos padded to [N, 128] with the mask in lane 2, m and l
// replicated over a lane tile, D zero-padded to 128 in device memory) are
// gone: pos and the bool mask are read as they are.
//
// Design. The D columns of a head are cut into G slices of DPT columns
// (D <= DPT * G; columns past D are zero in shared memory only). A thread
// owns one (head, slice) of kRows query rows of its block's tile: their q
// slices (times scale), their slices of the f32 accumulator, m and l. The
// block stages a tile of BK keys (K, V as f32, the validity of each key, and
// the [BQ, BK] bias tile) in shared memory. Per chunk of 8 keys a thread forms
// its partial q.k dots from 16-byte shared loads, the G slices of a head add
// them up with xor shuffles, then one online-softmax update per row (one exp
// for the rescale, one per key) and the p.v sums into the accumulator slices.
// Each K or V vector read from shared memory feeds all kRows rows: with one
// row a thread does 4 FMAs per 16-byte load and the shared-memory pipe, not
// the FMA units, sets the time; two rows halve the loads (four rows need more
// registers than leave two blocks on an SM, and were slower). Slices are 4
// floats apart in a tile row so that the 16-byte loads of the slices of one
// row fall on different banks.
//
// Numerics, kept from the TPU kernels: inputs upcast to f32, q * scale before
// the product, per-component differences and sqrt(max(dx^2 + dy^2, 1e-12))
// for the distance, -1e30 on masked keys, p multiplied by the validity after
// the exp (so a row that has seen no valid key accumulates nothing), and
// acc / max(l, 1e-20) with one cast to the output type at the end.
//
// Bound on the H100 at B=32, N=1024, H=8, D=16 bf16: q, k, v, out once are
// 33.6 MB (0.010 ms at 3.35 TB/s); the two products are 17.2 GFLOP. These
// kernels run them as f32 FMAs outside the tensor cores (Large has D = 8,
// below the depth of a bf16 mma), so the f32 rate binds this design: 0.26 ms
// at 67 TFLOP/s, plus 268 M exp. Tensor cores (wgmma, with D padded in
// registers) and TMA-fed tiles are the next design.
//
// N must be a multiple of the tile sizes the launcher picks (it is called
// with N % 128 == 0). q, k, v, out are bf16 or f32, contiguous [B, N, H, D]
// and 16-byte aligned; pos is f32 [B, N, 2]; node_mask is one byte per node.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 8;      // keys per online-softmax update
constexpr int kPad = 4;        // floats between the slices of a tile row
constexpr int kRows = 2;       // query rows per thread
constexpr int kThreads = 256;  // per block
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// Offset of column `dim` of block-local head `hl` inside a tile row.
template <int DPT, int G>
__device__ __forceinline__ int tile_col(int hl, int dim) {
  return (hl * G + dim / DPT) * (DPT + kPad) + dim % DPT;
}

// Copies `rows` rows of `nh` heads of true width d into a tile, as f32. `src`
// points at (first row, first head, column 0); rows are src_stride elements
// apart and the heads of a row are contiguous.
template <typename T, int DPT, int G>
__device__ void load_tile(float* dst, const T* src, int rows, int nh, int d,
                          int64_t src_stride, int rowstride) {
  const int per_row = nh * d;
  if ((d & 3) == 0) {
    const int groups = per_row >> 2;
    for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
      const int j = i / groups;
      const int e = (i - j * groups) << 2;
      const int hl = e / d;
      float v[4];
      load4(src + j * src_stride + e, v);
      float* o = dst + j * rowstride + tile_col<DPT, G>(hl, e - hl * d);
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int j = i / per_row;
      const int e = i - j * per_row;
      const int hl = e / d;
      dst[j * rowstride + tile_col<DPT, G>(hl, e - hl * d)] =
          to_float(src[j * src_stride + e]);
    }
  }
}

// The bias tile of (query rows of qpos, keys kpos[0..bk)): computed once per
// tile pair by the whole block, per-component differences.
__device__ void bias_tile(float* bias, const float* qpos, const float* kpos,
                          int bq, int bk, float inv_tau) {
  for (int t = threadIdx.x; t < bq * bk; t += blockDim.x) {
    const int i = t / bk;
    const int j = t - i * bk;
    const float dx = qpos[2 * i] - __ldg(kpos + 2 * j);
    const float dy = qpos[2 * i + 1] - __ldg(kpos + 2 * j + 1);
    bias[i * (bk + 1) + j] = -sqrtf(fmaxf(dx * dx + dy * dy, 1e-12f)) * inv_tau;
  }
}

// One thread's state: a slice of one (query row, head).
template <int DPT>
struct RowState {
  float q[DPT];     // q slice, already times scale
  float acc[DPT];   // accumulator slice
  float m, l;
};

// One key tile for one thread and its R query rows: scores from the staged K,
// online softmax, accumulation from the staged V. Every K and V vector read
// from shared memory feeds all R rows. `ks` and `vs` point at this thread's
// slice of row 0 of the tiles; `brow` at the bias of the thread's first query
// row, its other rows `brow_step` floats further each.
template <int DPT, int G, int R>
__device__ __forceinline__ void attend_tile(RowState<DPT> (&st)[R], const float* ks,
                                            const float* vs, const float* brow,
                                            int brow_step, const float* kvalid, int bk,
                                            int rowstride) {
  for (int jc = 0; jc < bk; jc += kChunk) {
    float s[R][kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float* kr = ks + (jc + c) * rowstride;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) s[rr][c] = 0.f;
#pragma unroll
      for (int dd = 0; dd < DPT; dd += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float a = s[rr][c];
          a = fmaf(st[rr].q[dd], kk.x, a);
          a = fmaf(st[rr].q[dd + 1], kk.y, a);
          a = fmaf(st[rr].q[dd + 2], kk.z, a);
          a = fmaf(st[rr].q[dd + 3], kk.w, a);
          s[rr][c] = a;
        }
      }
    }
    if (G > 1) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
#pragma unroll
          for (int off = G >> 1; off > 0; off >>= 1)
            s[rr][c] += __shfl_xor_sync(kFullMask, s[rr][c], off);
        }
      }
    }
    float ok[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) ok[c] = kvalid[jc + c];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float* b = brow + rr * brow_step + jc;
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[rr][c] = ok[c] > 0.5f ? s[rr][c] + b[c] : kNegInf;
        cmax = fmaxf(cmax, s[rr][c]);
      }
      const float m_new = fmaxf(st[rr].m, cmax);
      const float alpha = __expf(st[rr].m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        // exp(-1e30 - (-1e30)) is 1 on a masked key: the validity zeroes it
        s[rr][c] = __expf(s[rr][c] - m_new) * ok[c];
        psum += s[rr][c];
      }
      st[rr].l = st[rr].l * alpha + psum;
      st[rr].m = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) st[rr].acc[dd] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float* vr = vs + (jc + c) * rowstride;
#pragma unroll
      for (int dd = 0; dd < DPT; dd += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + dd);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          st[rr].acc[dd] = fmaf(s[rr][c], vv.x, st[rr].acc[dd]);
          st[rr].acc[dd + 1] = fmaf(s[rr][c], vv.y, st[rr].acc[dd + 1]);
          st[rr].acc[dd + 2] = fmaf(s[rr][c], vv.z, st[rr].acc[dd + 2]);
          st[rr].acc[dd + 3] = fmaf(s[rr][c], vv.w, st[rr].acc[dd + 3]);
        }
      }
    }
  }
}

template <typename T, int DPT>
__device__ __forceinline__ void init_state(RowState<DPT>& st, const T* qrow, int dim0,
                                           int d, float scale) {
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    st.q[dd] = dim0 + dd < d ? to_float(qrow[dim0 + dd]) * scale : 0.f;
    st.acc[dd] = 0.f;
  }
  st.m = kNegInf;
  st.l = 0.f;
}

template <typename T, int DPT>
__device__ __forceinline__ void write_state(const RowState<DPT>& st, T* orow, int dim0,
                                            int d) {
  const float denom = fmaxf(st.l, 1e-20f);
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd)
    if (dim0 + dd < d) store_as(orow + dim0 + dd, st.acc[dd] / denom);
}

struct Tiles {
  float* ks;       // [bk][rowstride]
  float* vs;       // [bk][rowstride]
  float* bias;     // [bq][bk + 1]
  float* kvalid;   // [bk]
  float* qpos;     // [bq][2]
};

__device__ __forceinline__ Tiles carve(float* smem, int bq, int bk, int rowstride) {
  Tiles t;
  t.ks = smem;
  t.vs = t.ks + bk * rowstride;
  t.bias = t.vs + bk * rowstride;
  t.kvalid = t.bias + bq * (bk + 1);
  t.qpos = t.kvalid + bk;
  return t;
}

// Packed heads: the block's threads are (query row group, head, slice) for all
// H heads; a thread owns rows r, r + bq/R, ... of its tile; grid (N / bq, B).
template <typename T, int DPT, int G, int R>
__global__ void __launch_bounds__(kThreads)
flash_spatial_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ pos,
                            const uint8_t* __restrict__ mask, T* __restrict__ out,
                            int n, int heads, int d, int bq, int bk,
                            float scale, float inv_tau) {
  extern __shared__ float4 smem4[];
  const int tpr = heads * G;                       // threads per query row
  const int rowstride = tpr * (DPT + kPad);
  const Tiles t = carve(reinterpret_cast<float*>(smem4), bq, bk, rowstride);
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int64_t node0 = static_cast<int64_t>(blockIdx.y) * n;   // first node of the graph
  const int q0 = blockIdx.x * bq;
  const int r = threadIdx.x / tpr;
  const int slice = threadIdx.x - r * tpr;
  const int head = slice / G;
  const int dim0 = (slice - head * G) * DPT;

  const int rstep = bq / R;                        // rows between a thread's rows
  RowState<DPT> st[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    init_state<T, DPT>(st[rr], q + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d,
                       scale);
  for (int i = threadIdx.x; i < 2 * bq; i += blockDim.x)
    t.qpos[i] = pos[(node0 + q0) * 2 + i];
  if (d != DPT * G)                                // columns past d stay zero
    for (int i = threadIdx.x; i < 2 * bk * rowstride; i += blockDim.x) t.ks[i] = 0.f;

  for (int j0 = 0; j0 < n; j0 += bk) {
    __syncthreads();                               // the previous tile is consumed
    load_tile<T, DPT, G>(t.ks, k + (node0 + j0) * hd, bk, heads, d, hd, rowstride);
    load_tile<T, DPT, G>(t.vs, v + (node0 + j0) * hd, bk, heads, d, hd, rowstride);
    for (int i = threadIdx.x; i < bk; i += blockDim.x)
      t.kvalid[i] = mask[node0 + j0 + i] ? 1.f : 0.f;
    // one bias tile for this (query tile, key tile), shared by every head
    bias_tile(t.bias, t.qpos, pos + (node0 + j0) * 2, bq, bk, inv_tau);
    __syncthreads();
    const int soff = slice * (DPT + kPad);
    attend_tile<DPT, G, R>(st, t.ks + soff, t.vs + soff, t.bias + r * (bk + 1),
                           rstep * (bk + 1), t.kvalid, bk, rowstride);
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    write_state<T, DPT>(st[rr], out + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d);
}

// Head-major: one (graph, head) per block, threads are (query row group,
// slice); grid (N / bq, H, B). The bias is formed per head, as in the TPU
// kernel.
template <typename T, int DPT, int G, int R>
__global__ void __launch_bounds__(kThreads)
flash_spatial_headmajor_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ pos,
                               const uint8_t* __restrict__ mask, T* __restrict__ out,
                               int n, int heads, int d, int bq, int bk,
                               float scale, float inv_tau) {
  extern __shared__ float4 smem4[];
  const int rowstride = G * (DPT + kPad);
  const Tiles t = carve(reinterpret_cast<float*>(smem4), bq, bk, rowstride);
  const int head = blockIdx.y;
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int64_t node0 = static_cast<int64_t>(blockIdx.z) * n;
  const int q0 = blockIdx.x * bq;
  const int r = threadIdx.x / G;
  const int slice = threadIdx.x - r * G;
  const int dim0 = slice * DPT;

  const int rstep = bq / R;                        // rows between a thread's rows
  RowState<DPT> st[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    init_state<T, DPT>(st[rr], q + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d,
                       scale);
  for (int i = threadIdx.x; i < 2 * bq; i += blockDim.x)
    t.qpos[i] = pos[(node0 + q0) * 2 + i];
  if (d != DPT * G)
    for (int i = threadIdx.x; i < 2 * bk * rowstride; i += blockDim.x) t.ks[i] = 0.f;

  for (int j0 = 0; j0 < n; j0 += bk) {
    __syncthreads();
    load_tile<T, DPT, G>(t.ks, k + (node0 + j0) * hd + head * d, bk, 1, d, hd, rowstride);
    load_tile<T, DPT, G>(t.vs, v + (node0 + j0) * hd + head * d, bk, 1, d, hd, rowstride);
    for (int i = threadIdx.x; i < bk; i += blockDim.x)
      t.kvalid[i] = mask[node0 + j0 + i] ? 1.f : 0.f;
    bias_tile(t.bias, t.qpos, pos + (node0 + j0) * 2, bq, bk, inv_tau);
    __syncthreads();
    const int soff = slice * (DPT + kPad);
    attend_tile<DPT, G, R>(st, t.ks + soff, t.vs + soff, t.bias + r * (bk + 1),
                           rstep * (bk + 1), t.kvalid, bk, rowstride);
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    write_state<T, DPT>(st[rr], out + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d);
}

struct Args {
  const void *q, *k, *v, *pos, *mask;
  void* out;
  int batch, n, heads, d;
  float scale, inv_tau;
  cudaStream_t stream;
};

template <typename T, int DPT, int G, bool PACKED>
cudaError_t launch_cfg(const Args& a) {
  const int tpr = (PACKED ? a.heads : 1) * G;      // threads per query row
  if (tpr > kThreads || (tpr & (tpr - 1)) != 0) return cudaErrorInvalidValue;
  int bq = kRows * kThreads / tpr;
  if (bq > 128) bq = 128;
  const int rowstride = tpr * (DPT + kPad);
  int bk = 32;
  auto bytes = [&](int keys) {
    return sizeof(float) * (2 * static_cast<size_t>(keys) * rowstride + bq * (keys + 1)
                            + keys + 2 * bq);
  };
  while (bk > kChunk && bytes(bk) > 200 * 1024) bk >>= 1;
  if (a.n % bq != 0 || a.n % bk != 0) return cudaErrorInvalidValue;
  const size_t smem = bytes(bk);
  auto kern = PACKED ? flash_spatial_packed_kernel<T, DPT, G, kRows>
                     : flash_spatial_headmajor_kernel<T, DPT, G, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n / bq, PACKED ? a.batch : a.heads, PACKED ? 1 : a.batch);
  kern<<<grid, bq / kRows * tpr, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.pos), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), a.n, a.heads, a.d, bq, bk, a.scale, a.inv_tau);
  return cudaGetLastError();
}

template <typename T, bool PACKED>
cudaError_t launch_width(const Args& a) {
  if (a.d <= 8) return launch_cfg<T, 8, 1, PACKED>(a);
  if (a.d <= 16) return launch_cfg<T, 16, 1, PACKED>(a);
  if (a.d <= 32) return launch_cfg<T, 16, 2, PACKED>(a);
  if (a.d <= 64) return launch_cfg<T, 16, 4, PACKED>(a);
  if (a.d <= 128) return launch_cfg<T, 16, 8, PACKED>(a);
  if constexpr (!PACKED) {                         // packed heads have D <= 128
    if (a.d <= 256) return launch_cfg<T, 16, 16, PACKED>(a);
  }
  return cudaErrorInvalidValue;
}

template <bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* mask,
           void* out, int64_t batch, int64_t n, int64_t heads, int64_t d, float scale,
           float inv_tau, int is_bf16, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || d <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PACKED && heads * d != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, pos, mask, out, static_cast<int>(batch), static_cast<int>(n),
               static_cast<int>(heads), static_cast<int>(d), scale, inv_tau,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = is_bf16 ? launch_width<__nv_bfloat16, PACKED>(a)
                                  : launch_width<float, PACKED>(a);
  return static_cast<int>(err);
}

}  // namespace

// Both launch on `stream`, on the caller's current device.
extern "C" int flash_spatial_packed_launch(const void* q, const void* k, const void* v,
                                           const void* pos, const void* mask, void* out,
                                           int64_t batch, int64_t n, int64_t heads,
                                           int64_t d, float scale, float inv_tau,
                                           int is_bf16, void* stream) {
  return launch<true>(q, k, v, pos, mask, out, batch, n, heads, d, scale, inv_tau,
                      is_bf16, stream);
}

extern "C" int flash_spatial_headmajor_launch(const void* q, const void* k, const void* v,
                                              const void* pos, const void* mask, void* out,
                                              int64_t batch, int64_t n, int64_t heads,
                                              int64_t d, float scale, float inv_tau,
                                              int is_bf16, void* stream) {
  return launch<false>(q, k, v, pos, mask, out, batch, n, heads, d, scale, inv_tau,
                       is_bf16, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
