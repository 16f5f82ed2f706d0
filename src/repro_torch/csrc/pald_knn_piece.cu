// Sparse k-NN PaLD cohesion values past k = 1024 on Hopper, the features
// source past 64 features: pald_knn_reg.cuh's register tiles in pieces of
// 32 features (knn_feat_piece_kernel; its note has the design).  A source
// of its own beside pald_knn_large.cu and pald_knn_wide.cu, so the three
// build in parallel.
#include <cstdint>

#include "pald_knn_reg.cuh"

// The large-k features source for d > 64:
// pald_knn_values_features_large_f32's arguments, results and scratch.
extern "C" int pald_knn_values_features_piece_f32(
    const float* dn, const float* X, int64_t d, const int* idx, float* out,
    int64_t n, int k, int metric, int64_t row_off, int nbr, int64_t items,
    int64_t xstride, float* scratch, int wid, float p0, float p1,
    void* stream) {
  return pald::knn::reg_entry<0>(
      {dn, X, d, xstride, idx, out, n, k, metric, row_off, nbr != 0, items,
       scratch, {p0, p1}, static_cast<cudaStream_t>(stream)},
      wid);
}
