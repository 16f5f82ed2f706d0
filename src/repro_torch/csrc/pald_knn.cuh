// What the sparse k-NN values kernels share: pald_knn.cu (every source, k
// <= 1024 and the large-k variant past it) and pald_knn_large.cu (the
// large-k variant's features source at feature widths up to kRegMaxD).
#pragma once

#include <cstdint>

#include "pald_weights.cuh"

namespace pald::knn {

constexpr int kLargeK = 1024;         // past it the large-k variant
constexpr int64_t kMaxItems = 65535;  // items of one grid (gridDim.y)
constexpr int kBigGrid = 1024;        // large-k: row blocks of a grid

// The large-k features source in registers (pald_knn_large.cu): its
// threads on a row, the rows of a staged tile, and the widest d it takes
constexpr int kRegThreads = 256;
constexpr int kRegTile = 256;
constexpr int kRegMaxD = 16;

// the compile-time feature width of d (zero-padded): 8 or 16
__host__ __device__ constexpr int reg_width(int64_t d) {
  return d <= 8 ? 8 : 16;
}

// its shared memory at width d: a tile of kRegTile staged rows, each the
// features, norm, dn, index and W
__host__ __device__ constexpr int reg_smem_bytes(int64_t d) {
  return kRegTile * (reg_width(d) + 4) * static_cast<int>(sizeof(float));
}

// the support of z for the pair (x, y): the functional's own, or for a
// functional with a share (F::kHasShare: soft, a user functional that
// declares one) share * focus on the same triple, the plain version's
// reuse of its focus cube
template <class F>
struct KnnSupport {
  __device__ __forceinline__ static float eval(float own, float other,
                                               float pair, bool own_wins,
                                               const Params& p) {
    if constexpr (F::kHasShare)
      return __fmul_rn(F::share(own, other, p),
                       F::focus(own, other, pair, p));
    else
      return F::support(own, other, pair, own_wins, p);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

}  // namespace pald::knn
