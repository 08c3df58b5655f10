// Flash spatial attention: masked softmax attention over the nodes of a graph
// with the distance bias -|p_i - p_j| / tau, without any [N, N] array in
// device memory.
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:].k[b,j,h,:]
//                                     - |pos[b,i] - pos[b,j]| / tau) * v[b,j,h,:]
//   over the keys j with node_mask[b, j]; a graph without a valid key gives 0.
//
// Two entry points, replacing the two TPU kernels of
// dgdm_histopath_tpu/ops/pallas/flash_spatial.py:
//   flash_spatial_packed_launch     <- _flash_kernel_packed (:101): H * D = 128.
//     A block covers a tile of query rows of one graph and a group of its
//     heads (all H heads in the f32 kernel); the distance bias of a (query,
//     key) pair is computed once and used by every head of the group.
//   flash_spatial_headmajor_launch  <- _flash_kernel (:47): any H and D <= 256.
//     A block covers a tile of query rows of one (graph, head) pair.
// Both read q, k, v in place from [B, N, H, D] at the true D, pos as f32
// [B, N, 2] and the mask as one byte per node: the TPU kernels' 128-lane
// devices (pos padded to [N, 128] with the mask in lane 2, lane-replicated m
// and l, D zero-padded to 128 in device memory) are gone. The TPU grid walks
// the key blocks in order and carries m, l, acc in scratch between grid steps;
// thread blocks on Hopper run in no order, so a block loops over the key tiles
// itself and keeps m, l and the accumulator in registers.
//
// bf16 and f16 inputs: tensor cores (flash_spatial_{packed,headmajor}_mma_kernel,
// one instantiation per type; mma.sync .bf16 or .f16, which share the fragment
// layout, so ldmatrix and every index below serve both). The text below says
// bf16 for either; only the split of p differs (split_pair).
//   * A warp owns 16 query rows and HG heads; a block has WR warps (WR row
//     groups of 16 rows, the same HG heads) and the grid's y tiles the heads.
//     q fragments are loaded once into registers (from a shared-memory copy,
//     by ldmatrix).
//   * K and V tiles of BK keys (with the keys' pos and mask bytes) stay bf16
//     in shared memory, filled by cp.async into two stages, so the copy of
//     tile t + 1 runs under the math of tile t. A head's D columns are padded
//     to DP (8, or a multiple of 16) in shared memory only; tile rows are an
//     odd number of 16-byte units apart, so ldmatrix (and ldmatrix.trans for
//     V) reads 8 rows from 8 different bank groups.
//   * Each lane computes the bias of the (row, key) pairs its S fragment
//     holds, once per key tile, and every head of the warp reuses it (the TPU
//     kernel's one idea). It is kept in units of the unscaled q.k and is the
//     accumulator the product starts from: sc = Q.K^T + bias / scale by
//     mma.sync m16n8k16 (m16n8k8 for DP = 8), bf16 in, f32 out. Masked keys
//     get -1e30.
//   * The scale multiplies the f32 sc, not the bf16 q (1/sqrt(D) is no power
//     of two: rounding q * scale to bf16 would lose what the f32 reference
//     keeps). log2(e) is folded into it, so p = ex2(sc * scale_l2 - m) is one
//     FFMA and one ex2.approx.
//   * Online softmax on the fragments once per key tile: the row max by two
//     quad shuffles, one exp per element, one rescale per row. A key tile
//     with no valid key is skipped whole; that is exact (the reference leaves
//     m, l and acc as they were), and an all-masked graph gives zeros. In any
//     other tile the new max is finite, so exp(-1e30 - m) is exactly 0: the
//     reference's "p times the validity" holds without the multiply.
//   * P.V on tensor cores from the S fragment repacked in registers (the C
//     layout of two n8 tiles is the A layout of one k16). p is split into
//     hi + lo bf16 (hi = p truncated, lo = p - hi rounded) and both are
//     multiplied by V: p rounded once to bf16 (2^-9 relative) would miss the
//     f32 reference by more than 1e-4 on O(1) outputs; hi + lo is within
//     2^-16 of p. l is the same product with a column of ones (two more mma
//     per 16 keys instead of 32 adds a lane), and the end is
//     acc / max(l, 1e-20) with one cast to bf16.
//   * What binds it on the H100 is instruction issue: per score and head,
//     one FMNMX, one FFMA, one ex2, three split instructions and a share of
//     the bias and the mma; removing the ex2 alone does not make it faster.
//     Head-major at 64 rows a block also waited on L2 for its K/V tiles, so
//     its blocks take 128 rows.
//
// f32 inputs: FMAs outside the tensor cores (flash_spatial_{packed,
//   headmajor}_kernel). They hold the 1e-4 limit f32 needs, which a bf16
//   product could not; 3xTF32 would be the tensor-core route. A thread owns
//   one (head, slice of DPT columns) of kRows query rows; the block stages a
//   tile of BK keys (K, V as f32, validity, the [BQ, BK] bias tile, computed
//   once per tile pair) in shared memory, and per chunk of 8 keys a thread
//   forms its partial dots from 16-byte shared loads, the G slices of a head
//   add them with xor shuffles, then one online-softmax update per row and
//   the p.v sums. Each K or V vector read from shared memory feeds both of a
//   thread's rows: the shared-memory pipe, not the FMA units, sets the time.
//
// Numerics kept from the TPU kernels in both paths: f32 online softmax,
// per-component differences and sqrt(max(dx^2 + dy^2, 1e-12)) for the
// distance (ADR-0004), -1e30 on masked keys, a zero contribution from a
// masked key, acc / max(l, 1e-20) and one cast at the end.
//
// Bounds on the H100 SXM (dense peaks; the operations count valid keys only).
// Packed at B = 32, N = 1024, 8 x 16 (DGDM-Base): q, k, v, out once are
// 33.6 MB, 0.010 ms at 3.35 TB/s; the two products 17.2 GFLOP, 0.017 ms at
// 989 TFLOP/s bf16. Neither binds this design: it evaluates one exp per
// (query, head, key), 268 M here and at DGDM-Large's B = 4, N = 2048, 16 x 8,
// and the special-function units do 16 a clock per SM (3.7-4.2 T/s over 132
// SMs at 1.75-1.98 GHz), an exp floor of 0.064-0.073 ms; the bias adds one
// sqrt per (query, key) for each warp's head group. Head-major 4 x 64 at
// B = 8: 33.5 M exps (0.008-0.009 ms) plus as many sqrts, next to 0.0085 ms
// of tensor-core work. f32: 17.2 GFLOP at 67 TFLOP/s is 0.26 ms at Base.
//
// N must be a multiple of 128 (the wrapper's route sends no other N). q, k, v, out
// are contiguous [B, N, H, D] and 16-byte aligned; pos (f32 [B, N, 2]) and the
// mask (one byte per node) are contiguous and 16-byte aligned.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

using bf16 = __nv_bfloat16;
using f16 = __half;

// ---------------------------------------------------------------------------
// f32: FMAs from shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kChunk = 8;      // keys per online-softmax update
constexpr int kPad = 4;        // floats between the slices of a tile row
constexpr int kRows = 2;       // query rows per thread
constexpr int kThreads = 256;  // per block

// Offset of column `dim` of block-local head `hl` inside a tile row.
template <int DPT, int G>
__device__ __forceinline__ int tile_col(int hl, int dim) {
  return (hl * G + dim / DPT) * (DPT + kPad) + dim % DPT;
}

// Copies `rows` rows of `nh` heads of true width d into a tile. `src` points
// at (first row, first head, column 0); rows are src_stride elements apart
// and the heads of a row are contiguous.
template <int DPT, int G>
__device__ void load_tile(float* dst, const float* src, int rows, int nh, int d,
                          int64_t src_stride, int rowstride) {
  const int per_row = nh * d;
  if ((d & 3) == 0) {
    const int groups = per_row >> 2;
    for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
      const int j = i / groups;
      const int e = (i - j * groups) << 2;
      const int hl = e / d;
      const float4 x = *reinterpret_cast<const float4*>(src + j * src_stride + e);
      *reinterpret_cast<float4*>(dst + j * rowstride + tile_col<DPT, G>(hl, e - hl * d)) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int j = i / per_row;
      const int e = i - j * per_row;
      const int hl = e / d;
      dst[j * rowstride + tile_col<DPT, G>(hl, e - hl * d)] = src[j * src_stride + e];
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

template <int DPT>
__device__ __forceinline__ void init_state(RowState<DPT>& st, const float* qrow, int dim0,
                                           int d, float scale) {
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    st.q[dd] = dim0 + dd < d ? qrow[dim0 + dd] * scale : 0.f;
    st.acc[dd] = 0.f;
  }
  st.m = kNegInf;
  st.l = 0.f;
}

template <int DPT>
__device__ __forceinline__ void write_state(const RowState<DPT>& st, float* orow, int dim0,
                                            int d) {
  const float denom = fmaxf(st.l, 1e-20f);
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd)
    if (dim0 + dd < d) orow[dim0 + dd] = st.acc[dd] / denom;
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
template <int DPT, int G, int R>
__global__ void __launch_bounds__(kThreads)
flash_spatial_packed_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ pos,
                            const uint8_t* __restrict__ mask, float* __restrict__ out,
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
    init_state<DPT>(st[rr], q + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d, scale);
  for (int i = threadIdx.x; i < 2 * bq; i += blockDim.x)
    t.qpos[i] = pos[(node0 + q0) * 2 + i];
  if (d != DPT * G)                                // columns past d stay zero
    for (int i = threadIdx.x; i < 2 * bk * rowstride; i += blockDim.x) t.ks[i] = 0.f;

  for (int j0 = 0; j0 < n; j0 += bk) {
    __syncthreads();                               // the previous tile is consumed
    load_tile<DPT, G>(t.ks, k + (node0 + j0) * hd, bk, heads, d, hd, rowstride);
    load_tile<DPT, G>(t.vs, v + (node0 + j0) * hd, bk, heads, d, hd, rowstride);
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
    write_state<DPT>(st[rr], out + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d);
}

// Head-major: one (graph, head) per block, threads are (query row group,
// slice); grid (N / bq, H, B). The bias is formed per head, as in the TPU
// kernel.
template <int DPT, int G, int R>
__global__ void __launch_bounds__(kThreads)
flash_spatial_headmajor_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ pos,
                               const uint8_t* __restrict__ mask, float* __restrict__ out,
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
    init_state<DPT>(st[rr], q + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d, scale);
  for (int i = threadIdx.x; i < 2 * bq; i += blockDim.x)
    t.qpos[i] = pos[(node0 + q0) * 2 + i];
  if (d != DPT * G)
    for (int i = threadIdx.x; i < 2 * bk * rowstride; i += blockDim.x) t.ks[i] = 0.f;

  for (int j0 = 0; j0 < n; j0 += bk) {
    __syncthreads();
    load_tile<DPT, G>(t.ks, k + (node0 + j0) * hd + head * d, bk, 1, d, hd, rowstride);
    load_tile<DPT, G>(t.vs, v + (node0 + j0) * hd + head * d, bk, 1, d, hd, rowstride);
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
    write_state<DPT>(st[rr], out + (node0 + q0 + r + rr * rstep) * hd + head * d, dim0, d);
}

// ---------------------------------------------------------------------------
// bf16 and f16: tensor cores (mma.sync), cp.async double buffering
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d = a . b + c, a 16 x 16 (row), b 16 x 8 (col), T (bf16 or f16) in, f32
// accumulate; the two types share the fragment layout, so ldmatrix and the
// repacking of P serve both. A pure register operation: no volatile, the
// compiler may schedule it.
template <typename T>
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1, const float (&c)[4]) {
  if constexpr (std::is_same_v<T, bf16>) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
}

template <typename T>
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  mma_k16<T>(c, a, b0, b1, c);
}

// d = a . b + c, a 16 x 8 (row), b 8 x 8 (col)
template <typename T>
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                       const float (&c)[4]) {
  if constexpr (std::is_same_v<T, bf16>) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bias of one (query, key) pair times `mul`; a masked key gets -1e30.
__device__ __forceinline__ float pair_bias(float qx, float qy, float kx, float ky, bool valid,
                                           float mul) {
  const float dx = qx - kx;
  const float dy = qy - ky;
  return valid ? -sqrt_approx(fmaxf(dx * dx + dy * dy, 1e-12f)) * mul : kNegInf;
}

// (hi, lo) pairs of T of two f32 values x0 (low half) and x1 in [0, 1]: hi
// rounds toward zero, lo = x - hi rounded to nearest, and hi + lo stands for
// x. bf16: hi keeps the top 16 bits of x's pattern (a truncation), and
// hi + lo is within 2^-16 of x. f16 has a 5-bit exponent, so the bit trick
// does not carry over: hi = __float2half_rz(x) (11 significant bits down
// to 2^-14, subnormal steps of 2^-24 below), lo the rest rounded, within
// 2^-22 of x where it is normal and 2^-25 absolute where it is subnormal
// (lo underflows below ~6e-8); against the accumulated l >= 1 that is below
// one f16 rounding of the output.
template <typename T>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same_v<T, bf16>) {
    const uint32_t u0 = __float_as_uint(x0);
    const uint32_t u1 = __float_as_uint(x1);
    hi = __byte_perm(u0, u1, 0x7632);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                                   x1 - __uint_as_float(u1 & 0xffff0000u));
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half h0 = __float2half_rz(x0);
    const __half h1 = __float2half_rz(x1);
    const __half2 h = __halves2half2(h0, h1);
    const __half2 l = __floats2half2_rn(x0 - __half2float(h0), x1 - __half2float(h1));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Two 1.0 of T in one register: the column of ones that sums p into l.
template <typename T>
__device__ __forceinline__ constexpr uint32_t ones_pair() {
  return std::is_same_v<T, bf16> ? 0x3f803f80u : 0x3c003c00u;
}

// x0 (low half) and x1 rounded to nearest into a pair of T.
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float x0, float x1) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&p);
  } else {
    const __half2 p = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
}

template <typename T>
__device__ __forceinline__ T round_one(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16(x);
  else return __float2half(x);
}

// Tiling of one kernel instance. DP: a head's columns in shared memory (8 or
// a multiple of 16); HG heads per warp and per block; WR row groups of 16
// rows per block; BK keys per tile.
template <int DP, int HG, int WR, int BK>
struct MmaCfg {
  static constexpr int kCols = HG * DP;
  // an odd number of 16-byte units per row: ldmatrix is free of conflicts
  static constexpr int kStride = kCols + ((kCols / 8) % 2 == 0 ? 8 : 0);
  static constexpr int kRowsQ = 16 * WR;
  static constexpr int kThreads = 32 * WR;
  static constexpr int kNT = BK / 8;                  // n8 key tiles of S
  static constexpr int kKS = DP / 16;                 // k16 steps of q.k (DP >= 16)
  static constexpr int kND = DP / 8;                  // n8 column tiles of the output
  static constexpr int kQRegs = DP == 8 ? 2 : 4 * kKS;  // q fragment registers per head
  static constexpr bool kQInRegs = HG * DP <= 128;     // else ldmatrix per tile
  static constexpr int kTile = BK * kStride;          // 2-byte values of one K or V tile
  static constexpr size_t kSmem =
      2 * (kRowsQ * kStride + 4 * kTile) + sizeof(float) * 2 * BK * 2 + 2 * BK;
  static_assert(DP == 8 || DP % 16 == 0, "DP is 8 or a multiple of 16");
  static_assert(BK == 16 || BK == 32 || BK == 64, "BK is 16, 32 or 64");
  static_assert(DP != 8 || BK >= 32, "DP = 8 takes K fragments 4 key tiles at a time");
};

// Copies ROWS node rows of NH heads of true width d from global memory
// (`src` at (first row, first head, column 0), rows src_stride apart) into a
// shared tile whose heads are DP columns apart. 16- or 8-byte cp.async where
// d allows it, else plain loads and stores.
template <typename T, int DP, int NH, int ROWS>
__device__ __forceinline__ void copy_rows(T* dst, int stride, const T* src,
                                          int64_t src_stride, int d) {
  if (DP % 8 == 0 && d == DP) {                      // the common case, all constants
    constexpr int cpr = DP / 8;
    for (int i = threadIdx.x; i < ROWS * NH * cpr; i += blockDim.x) {
      const int r = i / (NH * cpr);
      const int c = i % (NH * cpr);
      cp_async16(smem_u32(dst + r * stride + c * 8), src + r * src_stride + c * 8);
    }
    return;
  }
  constexpr int rows = ROWS, nh = NH;
  if ((d & 3) == 0) {
    const int sh = (d & 7) == 0 ? 3 : 2;             // log2 of elements per copy
    const int cpr = d >> sh;                         // copies per head row
    const int per_row = nh * cpr;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      const int h = c / cpr;
      const int e = (c - h * cpr) << sh;
      const uint32_t to = smem_u32(dst + r * stride + h * DP + e);
      const T* from = src + r * src_stride + h * d + e;
      if (sh == 3) cp_async16(to, from);
      else cp_async8(to, from);
    }
  } else {
    const int per_row = nh * d;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      const int h = c / d;
      const int e = c - h * d;
      dst[r * stride + h * DP + e] = src[r * src_stride + h * d + e];
    }
  }
}

// One block: WR x 16 query rows of graph blockIdx.z, heads blockIdx.y * HG
// onward; grid (N / (16 WR), H / HG, B). scale_l2 = scale * log2(e);
// bias_s = log2(e) / (tau * scale_l2) = 1 / (tau * scale): the bias in units
// of the unscaled q.k, so that the product's accumulator starts from it.
template <typename T, int DP, int HG, int WR, int BK>
__device__ __forceinline__ void flash_mma_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ pos, const uint8_t* __restrict__ mask, T* __restrict__ out,
    int n, int heads, int d, float scale_l2, float bias_s) {
  using C = MmaCfg<DP, HG, WR, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const qs = reinterpret_cast<T*>(smem_raw);
  T* const ks = qs + C::kRowsQ * C::kStride;         // [2][BK][kStride]
  T* const vs = ks + 2 * C::kTile;                   // [2][BK][kStride]
  float* const kpos = reinterpret_cast<float*>(vs + 2 * C::kTile);   // [2][BK][2]
  uint8_t* const kmask = reinterpret_cast<uint8_t*>(kpos + 4 * BK);  // [2][BK]

  const int lane = threadIdx.x & 31;
  const int wr = threadIdx.x >> 5;                   // the warp's row group
  const int g = lane >> 2;                           // fragment row (and + 8)
  const int t = lane & 3;                            // fragment column pair
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int64_t node0 = static_cast<int64_t>(blockIdx.z) * n;
  const int q0 = blockIdx.x * C::kRowsQ;
  const int h0 = blockIdx.y * HG;

  if (d != DP) {                                     // pad columns read as zeros
    uint4* z = reinterpret_cast<uint4*>(qs);
    const int count = (C::kRowsQ * C::kStride + 4 * C::kTile) / 8;
    for (int i = threadIdx.x; i < count; i += C::kThreads) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  auto issue_tile = [&](int j0, int s) {
    copy_rows<T, DP, HG, BK>(ks + s * C::kTile, C::kStride,
                             k + (node0 + j0) * hd + h0 * d, hd, d);
    copy_rows<T, DP, HG, BK>(vs + s * C::kTile, C::kStride,
                             v + (node0 + j0) * hd + h0 * d, hd, d);
    for (int i = threadIdx.x; i < BK / 2; i += C::kThreads)       // 2 keys' (x, y)
      cp_async16(smem_u32(kpos + s * 2 * BK + 4 * i), pos + (node0 + j0) * 2 + 4 * i);
    for (int i = threadIdx.x; i < BK / 16; i += C::kThreads)
      cp_async16(smem_u32(kmask + s * BK + 16 * i), mask + node0 + j0 + 16 * i);
  };
  copy_rows<T, DP, HG, C::kRowsQ>(qs, C::kStride, q + (node0 + q0) * hd + h0 * d, hd, d);
  issue_tile(0, 0);
  cp_async_commit();

  const int row0 = q0 + wr * 16 + g;                 // this lane's rows: row0, row0 + 8
  float qx[2], qy[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qx[r] = pos[(node0 + row0 + 8 * r) * 2];
    qy[r] = pos[(node0 + row0 + 8 * r) * 2 + 1];
  }
  // per head: running max (log2 units) of rows g, g + 8; the output and the
  // softmax denominator as mma accumulators (l: p times a column of ones)
  float m_run[HG][2], acc[HG][C::kND][4], l_acc[HG][4];
  uint32_t qf[HG][C::kQInRegs ? C::kQRegs : 1];
#pragma unroll
  for (int i = 0; i < HG; ++i) {
    m_run[i][0] = m_run[i][1] = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) l_acc[i][e] = 0.f;
#pragma unroll
    for (int nd = 0; nd < C::kND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nd][e] = 0.f;
  }
  const uint32_t kOnes = ones_pair<T>();             // two 1.0 of T
  const T* const qwarp = qs + wr * 16 * C::kStride;
  // q fragments of (head column offset col, k16 step) by ldmatrix
  auto load_q = [&](uint32_t* f, int col, int step) {
    if constexpr (DP == 8) {
      ldsm_x2(f[0], f[1], smem_u32(qwarp + (lane & 15) * C::kStride + col));
    } else {
      const int m = lane >> 3;
      uint32_t r[4];
      ldsm_x4(r, smem_u32(qwarp + ((m & 1) * 8 + (lane & 7)) * C::kStride + col + step * 16 +
                          (m >> 1) * 8));
      f[0] = r[0], f[1] = r[1], f[2] = r[2], f[3] = r[3];
    }
  };

  const int tiles = n / BK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int s = tile & 1;
    if (tile + 1 < tiles) issue_tile((tile + 1) * BK, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                              // tile `tile` (and q) have landed
    __syncthreads();
    if constexpr (C::kQInRegs) {
      if (tile == 0) {
#pragma unroll
        for (int i = 0; i < HG; ++i) {
#pragma unroll
          for (int step = 0; step < (DP == 8 ? 1 : C::kKS); ++step)
            load_q(&qf[i][4 * step], i * DP, step);
        }
      }
    }
    const uint8_t* const km = kmask + s * BK;
    const unsigned any_valid = __any_sync(
        kFullMask, 2 * lane < BK && *reinterpret_cast<const uint16_t*>(km + 2 * lane) != 0);
    if (any_valid) {
      // the bias of this lane's (row, key) pairs in the accumulator layout,
      // once for the tile, the start of every head's q.k accumulator
      const float* const kp = kpos + s * 2 * BK;
      float bias[C::kNT][4];
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const int key = j * 8 + 2 * t;
        const float4 p = *reinterpret_cast<const float4*>(kp + 2 * key);
        const uint16_t mk = *reinterpret_cast<const uint16_t*>(km + key);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bias[j][2 * r] = pair_bias(qx[r], qy[r], p.x, p.y, (mk & 0xff) != 0, bias_s);
          bias[j][2 * r + 1] = pair_bias(qx[r], qy[r], p.z, p.w, (mk >> 8) != 0, bias_s);
        }
      }
      const T* const kt = ks + s * C::kTile;
      const T* const vt = vs + s * C::kTile;
#pragma unroll
      for (int i = 0; i < HG; ++i) {
        const int col = i * DP;
        // sc = Q . K^T + bias for the 16 rows and BK keys
        float sc[C::kNT][4];
        if constexpr (DP == 8) {
          uint32_t a[2];
          if constexpr (C::kQInRegs) a[0] = qf[i][0], a[1] = qf[i][1];
          else load_q(a, col, 0);
#pragma unroll
          for (int j = 0; j < C::kNT; j += 4) {
            uint32_t b[4];
            ldsm_x4(b, smem_u32(kt + ((j + (lane >> 3)) * 8 + (lane & 7)) * C::kStride + col));
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              mma_k8<T>(sc[j + jj], a[0], a[1], b[jj], bias[j + jj]);
          }
        } else {
#pragma unroll
          for (int step = 0; step < C::kKS; ++step) {
            uint32_t a[4];
            if constexpr (C::kQInRegs) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = qf[i][4 * step + e];
            } else {
              load_q(a, col, step);
            }
            const int m = lane >> 3;
#pragma unroll
            for (int j = 0; j < C::kNT; j += 2) {
              uint32_t b[4];
              ldsm_x4(b, smem_u32(kt + ((j + (m >> 1)) * 8 + (lane & 7)) * C::kStride + col +
                                  step * 16 + (m & 1) * 8));
              mma_k16<T>(sc[j], a, b[0], b[1], step == 0 ? bias[j] : sc[j]);
              mma_k16<T>(sc[j + 1], a, b[2], b[3], step == 0 ? bias[j + 1] : sc[j + 1]);
            }
          }
        }
        // online softmax, rows g and g + 8: the max of sc, two quad shuffles,
        // then p = 2^(sc * scale_l2 - m) by one FFMA and one ex2
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
        }
        float alpha[2], neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
          const float m_new = fmaxf(m_run[i][r], mx[r] * scale_l2);
          alpha[r] = ex2(m_run[i][r] - m_new);
          m_run[i][r] = m_new;
          neg_m[r] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = ex2(fmaf(sc[j][e], scale_l2, neg_m[e >> 1]));
#pragma unroll
        for (int nd = 0; nd < C::kND; ++nd) {
          acc[i][nd][0] *= alpha[0], acc[i][nd][1] *= alpha[0];
          acc[i][nd][2] *= alpha[1], acc[i][nd][3] *= alpha[1];
        }
        l_acc[i][0] *= alpha[0], l_acc[i][1] *= alpha[0];
        l_acc[i][2] *= alpha[1], l_acc[i][3] *= alpha[1];
        // acc += (p_hi + p_lo) . V and l += (p_hi + p_lo) . 1, a k16 chunk of
        // keys at a time
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
          uint32_t hi[4], lo[4];
          split_pair<T>(sc[2 * kc][0], sc[2 * kc][1], hi[0], lo[0]);
          split_pair<T>(sc[2 * kc][2], sc[2 * kc][3], hi[1], lo[1]);
          split_pair<T>(sc[2 * kc + 1][0], sc[2 * kc + 1][1], hi[2], lo[2]);
          split_pair<T>(sc[2 * kc + 1][2], sc[2 * kc + 1][3], hi[3], lo[3]);
          mma_k16<T>(l_acc[i], hi, kOnes, kOnes);
          mma_k16<T>(l_acc[i], lo, kOnes, kOnes);
          if constexpr (DP == 8) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, smem_u32(vt + (kc * 16 + (lane & 15)) * C::kStride + col));
            mma_k16<T>(acc[i][0], hi, b0, b1);
            mma_k16<T>(acc[i][0], lo, b0, b1);
          } else {
            const int m = lane >> 3;
#pragma unroll
            for (int nd = 0; nd < C::kND; nd += 2) {
              uint32_t b[4];
              ldsm_x4_trans(b, smem_u32(vt + (kc * 16 + (m & 1) * 8 + (lane & 7)) * C::kStride +
                                        col + (nd + (m >> 1)) * 8));
              mma_k16<T>(acc[i][nd], hi, b[0], b[1]);
              mma_k16<T>(acc[i][nd + 1], hi, b[2], b[3]);
              mma_k16<T>(acc[i][nd], lo, b[0], b[1]);
              mma_k16<T>(acc[i][nd + 1], lo, b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();                                 // stage s is free for tile + 2
  }

#pragma unroll
  for (int i = 0; i < HG; ++i) {
    const int head = h0 + i;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = fmaxf(l_acc[i][2 * r], 1e-20f);
      T* const orow = out + (node0 + row0 + 8 * r) * hd + static_cast<int64_t>(head) * d;
#pragma unroll
      for (int nd = 0; nd < C::kND; ++nd) {
        const int dim = nd * 8 + 2 * t;
        const float x0 = acc[i][nd][2 * r] / denom;
        const float x1 = acc[i][nd][2 * r + 1] / denom;
        if ((d & 1) == 0) {
          if (dim < d) *reinterpret_cast<uint32_t*>(orow + dim) = pack_pair<T>(x0, x1);
        } else {
          if (dim < d) orow[dim] = round_one<T>(x0);
          if (dim + 1 < d) orow[dim + 1] = round_one<T>(x1);
        }
      }
    }
  }
}

template <typename T, int DP, int HG, int WR, int BK, int MINB>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_spatial_packed_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ pos,
                                const uint8_t* __restrict__ mask, T* __restrict__ out,
                                int n, int heads, int d, float scale_l2, float bias_s) {
  flash_mma_block<T, DP, HG, WR, BK>(q, k, v, pos, mask, out, n, heads, d, scale_l2, bias_s);
}

template <typename T, int DP, int HG, int WR, int BK, int MINB>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_spatial_headmajor_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const float* __restrict__ pos,
                                   const uint8_t* __restrict__ mask, T* __restrict__ out,
                                   int n, int heads, int d, float scale_l2, float bias_s) {
  flash_mma_block<T, DP, HG, WR, BK>(q, k, v, pos, mask, out, n, heads, d, scale_l2, bias_s);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *pos, *mask;
  void* out;
  int batch, n, heads, d;
  float scale, inv_tau;
  cudaStream_t stream;
};

template <int DPT, int G, bool PACKED>
cudaError_t launch_fma(const Args& a) {
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
  auto kern = PACKED ? flash_spatial_packed_kernel<DPT, G, kRows>
                     : flash_spatial_headmajor_kernel<DPT, G, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n / bq, PACKED ? a.batch : a.heads, PACKED ? 1 : a.batch);
  kern<<<grid, bq / kRows * tpr, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.pos),
      static_cast<const uint8_t*>(a.mask), static_cast<float*>(a.out), a.n, a.heads, a.d,
      bq, bk, a.scale, a.inv_tau);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_width_fma(const Args& a) {
  if (a.d <= 8) return launch_fma<8, 1, PACKED>(a);
  if (a.d <= 16) return launch_fma<16, 1, PACKED>(a);
  if (a.d <= 32) return launch_fma<16, 2, PACKED>(a);
  if (a.d <= 64) return launch_fma<16, 4, PACKED>(a);
  if (a.d <= 128) return launch_fma<16, 8, PACKED>(a);
  if constexpr (!PACKED) {                         // packed heads have D <= 128
    if (a.d <= 256) return launch_fma<16, 16, PACKED>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int DP, int HG, int WR, int BK, int MINB, bool PACKED>
cudaError_t launch_mma(const Args& a) {
  using C = MmaCfg<DP, HG, WR, BK>;
  if (a.heads % HG != 0 || a.n % C::kRowsQ != 0 || a.n % BK != 0)
    return cudaErrorInvalidValue;
  void (*kern)(const T*, const T*, const T*, const float*, const uint8_t*, T*,
               int, int, int, float, float);
  if constexpr (PACKED) kern = flash_spatial_packed_mma_kernel<T, DP, HG, WR, BK, MINB>;
  else kern = flash_spatial_headmajor_mma_kernel<T, DP, HG, WR, BK, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n / C::kRowsQ, a.heads / HG, a.batch);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.pos),
      static_cast<const uint8_t*>(a.mask), static_cast<T*>(a.out), a.n, a.heads, a.d,
      a.scale * kLog2e, a.inv_tau / a.scale);
  return cudaGetLastError();
}

// The tiling per head width, all rows free of register spills (ptxas -v).
// Three rows were chosen by timing on the H100 (PERF.md): packed D 8
// (DGDM-Large), packed D 16 (DGDM-Base) and head-major D 64 (4 x 64). The
// others are checked for correctness only, at N = 128. Packed heads
// (H * D = 128): a warp takes HG heads, so that one bias computation serves
// HG heads while their accumulators and q fragments stay in registers.
// Head-major: one head per warp, 128 rows per block (half the K/V traffic from
// L2 of 64 rows); D > 128 takes shorter key tiles.
template <typename T, bool PACKED>
cudaError_t launch_width_mma(const Args& a) {
  if constexpr (PACKED) {
    if (a.d <= 8) return launch_mma<T, 8, 4, 4, 64, 2, true>(a);
    if (a.d <= 16) return launch_mma<T, 16, 4, 4, 64, 2, true>(a);
    if (a.d <= 32) return launch_mma<T, 32, 2, 4, 64, 1, true>(a);
    if (a.d <= 64) return launch_mma<T, 64, 1, 4, 64, 1, true>(a);
    if (a.d <= 128) return launch_mma<T, 128, 1, 4, 32, 1, true>(a);
  } else {
    if (a.d <= 8) return launch_mma<T, 8, 1, 8, 64, 2, false>(a);
    if (a.d <= 16) return launch_mma<T, 16, 1, 8, 64, 2, false>(a);
    if (a.d <= 32) return launch_mma<T, 32, 1, 8, 64, 2, false>(a);
    if (a.d <= 64) return launch_mma<T, 64, 1, 8, 64, 2, false>(a);
    if (a.d <= 128) return launch_mma<T, 128, 1, 4, 32, 1, false>(a);
    if (a.d <= 256) return launch_mma<T, 256, 1, 4, 16, 1, false>(a);
  }
  return cudaErrorInvalidValue;
}

template <bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* mask,
           void* out, int64_t batch, int64_t n, int64_t heads, int64_t d, float scale,
           float inv_tau, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || d <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PACKED && heads * d != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, pos, mask, out, static_cast<int>(batch), static_cast<int>(n),
               static_cast<int>(heads), static_cast<int>(d), scale, inv_tau,
               static_cast<cudaStream_t>(stream)};
  // the dtype alone picks the path: tensor cores for bf16 and f16, FMAs for f32
  cudaError_t err;
  if (dtype == 1) err = launch_width_mma<bf16, PACKED>(a);
  else if (dtype == 2) err = launch_width_mma<f16, PACKED>(a);
  else if (dtype == 0) err = launch_width_fma<PACKED>(a);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Both launch on `stream`, on the caller's current device. `dtype` of q, k, v
// and out: 0 f32 (FMAs), 1 bf16, 2 f16 (tensor cores).
extern "C" int flash_spatial_packed_launch(const void* q, const void* k, const void* v,
                                           const void* pos, const void* mask, void* out,
                                           int64_t batch, int64_t n, int64_t heads,
                                           int64_t d, float scale, float inv_tau,
                                           int dtype, void* stream) {
  return launch<true>(q, k, v, pos, mask, out, batch, n, heads, d, scale, inv_tau,
                      dtype, stream);
}

extern "C" int flash_spatial_headmajor_launch(const void* q, const void* k, const void* v,
                                              const void* pos, const void* mask, void* out,
                                              int64_t batch, int64_t n, int64_t heads,
                                              int64_t d, float scale, float inv_tau,
                                              int dtype, void* stream) {
  return launch<false>(q, k, v, pos, mask, out, batch, n, heads, d, scale, inv_tau,
                       dtype, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
