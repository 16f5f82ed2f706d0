// Streaming k-nearest-neighbor selection on Hopper, straight from feature
// vectors: for every row x of X (n, d), its k nearest OTHER rows,
// ascending by (distance, index).  Replaces the TPU kernel
// repro/kernels/pald_topk.py::topk_pallas; the kernel, what bounds it and
// its design are in pald_topk.cuh.  This file holds the one-item and block
// entries; pald_topk_chunk.cu the entry of a chunk of items.
#include "pald_topk.cuh"

// pald_topk.cuh's topk for one X (n, d): out_v, out_i (n, k), `norms`
// (n,); `large`: the large-k variant (required past k = 1024).
extern "C" int pald_topk_f32(const float* x, float* norms, float* out_v,
                             int* out_i, int64_t n, int64_t d, int k,
                             int large, int metric, void* stream) {
  return pald::topk::topk<false>(x, norms, out_v, out_i, n, d, k, 1, large,
                                 metric, stream);
}

// The block entry: for each of the m rows of xr (m, d) (global index
// row_off + row), its k nearest among the w rows of xc (w, d) (global
// index col_off + col) other than itself (by global index), as
// (distance, global index) pairs into out_v / out_i (m, k), ascending on
// the same key; where fewer than k candidates remain, the rest are
// (+inf, INT32_MAX).  norms_r (m,) and norms_c (w,) are two 16-byte
// aligned float32 scratch buffers.  Needs m, w >= 1, k >= 1 (`large`, the
// large-k variant, past 1024), and every global index below 2^31 - 1.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pald_topk_block_f32(const float* xr, const float* xc,
                                   float* norms_r, float* norms_c,
                                   float* out_v, int* out_i, int64_t m,
                                   int64_t w, int64_t row_off,
                                   int64_t col_off, int64_t d, int k,
                                   int large, int metric, void* stream) {
  using namespace pald::topk;
  const int64_t top = static_cast<int64_t>(kSentinel);
  if (m < 1 || w < 1 || d < 0 || k < 1 || (k > kLargeK && !large) ||
      row_off < 0 || col_off < 0 || row_off + m > top || col_off + w > top)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(xr) && aligned16(xc);
  const Operands o{xr, xc, norms_r, norms_c, out_v, out_i, m, w,
                   row_off, col_off, d, k, vec, 1, large != 0};
  return pald::dispatch_metric(
      metric, TopkPerMetric<false>{o, static_cast<cudaStream_t>(stream)});
}

// The dynamic shared memory of a selection block at (k, d), in bytes, as
// launch_rows sets it (past kLargeK the large-k variant's); -1 for k < 1
// or a negative d.
extern "C" int pald_topk_smem_bytes(int k, int64_t d) {
  using namespace pald::topk;
  if (k < 1 || d < 0) return -1;
  if (k > kLargeK) return static_cast<int>(large_bytes(d));
  const int R = kWarps * warp_rows(k);
  return static_cast<int>(Layout(d, R).bytes(R, k));
}
