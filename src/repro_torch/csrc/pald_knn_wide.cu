// Sparse k-NN PaLD cohesion values past k = 1024 on Hopper, the features
// source at 16 < d <= 64 features: pald_knn_reg.cuh's register tiles at
// widths 32 and 64 (its note has the design).  A source of its own beside
// pald_knn_large.cu (widths 8 and 16) and pald_knn_piece.cu (past 64
// features), so the three build in parallel.
#include <cstdint>

#include "pald_knn_reg.cuh"

// The large-k features source for 16 < d <= 64:
// pald_knn_values_features_large_f32's arguments, results and scratch.
extern "C" int pald_knn_values_features_wide_f32(
    const float* dn, const float* X, int64_t d, const int* idx, float* out,
    int64_t n, int k, int metric, int64_t row_off, int nbr, int64_t items,
    int64_t xstride, float* scratch, int wid, float p0, float p1,
    void* stream) {
  return pald::knn::reg_entry<32, 64>(
      {dn, X, d, xstride, idx, out, n, k, metric, row_off, nbr != 0, items,
       scratch, {p0, p1}, static_cast<cudaStream_t>(stream)},
      wid);
}
