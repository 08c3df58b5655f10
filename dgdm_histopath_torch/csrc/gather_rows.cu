// Neighbor row gather: out[b, n, k, :] = src[b, idx[b, n, k], :].
//
// Replaces dgdm_histopath_tpu/ops/pallas/gather_rows.py::_fwd_kernel (the
// key gather of every DynamicGraphLayer). The TPU kernel built one-hot tiles
// in VMEM and ran the gather as MXU matmuls; on Hopper a gather is a plain
// copy, so this kernel moves bytes and does no arithmetic.
//
// Bound on the H100: bytes. At B=32, N=1024, K=8, F=128 bf16 it writes
// 67 MB, reads 8.4 MB of src and 1 MB of idx: ~76 MB, ~23 us at 3.35 TB/s.
// Design: each thread moves one chunk of a row, 16 bytes when the row size
// allows it (8 bf16 or 4 f32 values), so a 256-thread block copies 16 rows
// of 128 bf16 with fully coalesced 16-byte loads and stores. Rows whose
// byte size is not a multiple of 16 take the widest chunk that divides it
// (8, 4 or 2 bytes). Each src row is re-read by ~K rows of out; those
// re-reads of one graph's src (256 KB) stay in the 50 MB L2.
//
// The copy is bit-exact for any element type of 2 or 4 bytes. An index
// outside [0, N_src) writes a zero row, as the TPU one-hot kernel does (no
// iota matches). Any N, K and F are taken; no tiling constraint applies.
//
// The source table may hold another row count than the query: src is
// [B, N_src, F] and idx [B, N, K]. The node-sharded (halo) tier gathers a
// rank's N local rows from its [local || halo] table of N_src = N + tp*H
// rows, and its outgoing halo rows (N = tp, K = H) from its N_src local
// rows. The model's own gathers are square (N_src = N).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename Chunk>
__global__ void gather_rows_kernel(const Chunk* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   Chunk* __restrict__ out,
                                   int64_t rows, int64_t nk, int64_t n_src,
                                   int64_t chunks_per_row) {
  const int64_t total = rows * chunks_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / chunks_per_row;          // flat (b, n, k)
    const int64_t c = t - row * chunks_per_row;
    const int64_t b = row / nk;
    const int64_t j = __ldg(idx + row);
    Chunk v{};
    if (j >= 0 && j < n_src) v = src[(b * n_src + j) * chunks_per_row + c];
    out[t] = v;
  }
}

template <typename Chunk>
cudaError_t launch(const void* src, const int32_t* idx, void* out, int64_t rows,
                   int64_t nk, int64_t n_src, int64_t row_bytes, cudaStream_t stream) {
  const int64_t chunks = row_bytes / static_cast<int64_t>(sizeof(Chunk));
  const int threads = 256;
  int64_t blocks = (rows * chunks + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;      // grid-stride covers the rest
  gather_rows_kernel<Chunk><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const Chunk*>(src), idx, static_cast<Chunk*>(out), rows, nk, n_src,
      chunks);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, on the caller's current device. src holds n_src rows
// a graph, idx n rows of k slots.
extern "C" int gather_rows_launch(const void* src, const void* idx, void* out,
                                  int64_t batch, int64_t n, int64_t k, int64_t n_src,
                                  int64_t row_bytes, void* stream) {
  cudaError_t err;
  const int64_t rows = batch * n * k;
  const auto* ix = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) err = launch<uint4>(src, ix, out, rows, n * k, n_src, row_bytes, s);
  else if (row_bytes % 8 == 0) err = launch<uint2>(src, ix, out, rows, n * k, n_src, row_bytes, s);
  else if (row_bytes % 4 == 0) err = launch<uint32_t>(src, ix, out, rows, n * k, n_src, row_bytes, s);
  else if (row_bytes % 2 == 0) err = launch<uint16_t>(src, ix, out, rows, n * k, n_src, row_bytes, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
