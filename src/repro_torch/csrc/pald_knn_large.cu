// Sparse k-NN PaLD cohesion values past k = 1024 on Hopper, the features
// source at feature widths d <= 16: pald_knn_reg.cuh's register
// tiles at widths 8 and 16 (its note has the design).  pald_knn_wide.cu
// and pald_knn_piece.cu build the same tiles past 16 features.
#include <cstdint>

#include "pald_knn_reg.cuh"

// The large-k features source (pald_knn.cu's pald_knn_values_features_f32
// past k = 1024) for 0 <= d <= 16: the same arguments and results, bitwise
// its values for a functional whose focus is an exact count, within
// rounding for a smooth one.  Needs a scratch of 2 k float32 for each
// block of its grids (min(n, 1024) blocks times min(items, 65535)).
extern "C" int pald_knn_values_features_large_f32(
    const float* dn, const float* X, int64_t d, const int* idx, float* out,
    int64_t n, int k, int metric, int64_t row_off, int nbr, int64_t items,
    int64_t xstride, float* scratch, int wid, float p0, float p1,
    void* stream) {
  return pald::knn::reg_entry<8, 16>(
      {dn, X, d, xstride, idx, out, n, k, metric, row_off, nbr != 0, items,
       scratch, {p0, p1}, static_cast<cudaStream_t>(stream)},
      wid);
}
