// PaLD's two passes on Hopper straight from feature vectors, for a chunk
// of items (the engine's batch= chunks, the reference's vmap): the item is
// blockIdx.z of every grid, and each item's U and C are bitwise what the
// one-item entries of pald_fused.cu give it.  The kernels' chunk variants
// live in this translation unit alone, so nvcc builds them in parallel
// with the one-item ones; the kernels, what bounds them and their design
// are in pald_fused.cuh.  Replaces the TPU kernels
// repro/kernels/pald_fused.py::focus_fused_pallas and
// cohesion_fused_pallas under the reference's vmap.
#include "pald_fused.cuh"

// U (items, n, n) from X (items, n, d): pald_fused.cuh's focus_fused.
extern "C" int pald_focus_fused_chunk_f32(const float* x, float* norms,
                                          float* panel, float* u, int64_t n,
                                          int64_t d, int64_t n_valid,
                                          int64_t panel_rows, int64_t items,
                                          int metric, int wid, float p0,
                                          float p1, void* stream) {
  return pald::fused::focus_fused<true>(x, norms, panel, u, n, d, n_valid,
                                        panel_rows, items, metric, wid, p0,
                                        p1, stream);
}

// C (items, n, n) from X (items, n, d) and W (items, n, n):
// pald_fused.cuh's cohesion_fused.
extern "C" int pald_cohesion_fused_chunk_f32(
    const float* x, float* norms, float* panel, const float* w, float* c,
    int64_t n, int64_t d, int64_t n_valid, int64_t panel_rows, int64_t items,
    int metric, int wid, float p0, float p1, int add, void* stream) {
  return pald::fused::cohesion_fused<true>(x, norms, panel, w, c, n, d,
                                           n_valid, panel_rows, items, metric,
                                           wid, p0, p1, add, stream);
}
