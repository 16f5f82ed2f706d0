// Streaming k-nearest-neighbor selection on Hopper for a chunk of items
// (the engine's batch= chunks, the reference's vmap): the item is
// blockIdx.y, and each item's graph is bitwise what pald_topk.cu's
// one-item entry gives it.  The kernel's chunk variants live in this
// translation unit alone, so nvcc builds them in parallel with the
// one-item ones; the kernel, what bounds it and its design are in
// pald_topk.cuh.  Replaces the TPU kernel
// repro/kernels/pald_topk.py::topk_pallas under the reference's vmap.
#include "pald_topk.cuh"

// pald_topk.cuh's topk for `items` X (n, d), one after another: out_v,
// out_i (items, n, k), `norms` (items, n); `large`: the large-k variant
// (required past k = 1024).
extern "C" int pald_topk_chunk_f32(const float* x, float* norms,
                                   float* out_v, int* out_i, int64_t n,
                                   int64_t d, int k, int64_t items,
                                   int large, int metric, void* stream) {
  return pald::topk::topk<true>(x, norms, out_v, out_i, n, d, k, items,
                                large, metric, stream);
}
