// What the sparse k-NN values kernels share: pald_knn.cu (every source, k
// <= 1024, and the cube and D sources' large-k variants past it) and the
// large-k features source's register tiles (pald_knn_reg.cuh, built as
// pald_knn_large.cu, pald_knn_wide.cu and pald_knn_piece.cu).
#pragma once

#include <cstdint>

#include "pald_weights.cuh"

namespace pald::knn {

constexpr int kLargeK = 1024;         // past it the large-k variant
constexpr int64_t kMaxItems = 65535;  // items of one grid (gridDim.y)
constexpr int kBigGrid = 1024;        // large-k: row blocks of a grid

// The large-k features source in register tiles (pald_knn_reg.cuh; the
// entries of pald_knn_large.cu at widths 8 and 16, pald_knn_wide.cu at 32
// and kRegMaxWidth and pald_knn_piece.cu past it): its threads on a row,
// the rows of a staged tile, the widest width held in registers, and past
// it the features a piece and the staged rows a tile
constexpr int kRegThreads = 256;
constexpr int kRegTile = 256;
constexpr int kRegMaxWidth = 64;
constexpr int kPieceWidth = 32;
constexpr int kPieceRows = 32;

// the compile-time feature width of d (zero-padded): 8, 16, 32 or 64; past
// kRegMaxWidth d rounded up to whole pieces of kPieceWidth
__host__ __device__ constexpr int64_t reg_width(int64_t d) {
  return d <= 8    ? 8
         : d <= 16 ? 16
         : d <= 32 ? 32
         : d <= kRegMaxWidth
             ? kRegMaxWidth
             : (d + kPieceWidth - 1) / kPieceWidth * kPieceWidth;
}

// its shared memory at width d: a tile of kRegTile staged rows, each the
// features, norm, dn, index and W; past kRegMaxWidth a tile of kPieceRows
// rows, each a piece of the features and the same four, then each
// thread's owned piece at the same pitch
__host__ __device__ constexpr int reg_smem_bytes(int64_t d) {
  return d <= kRegMaxWidth
             ? kRegTile * (static_cast<int>(reg_width(d)) + 4) *
                   static_cast<int>(sizeof(float))
             : (kPieceRows + kRegThreads) * (kPieceWidth + 4) *
                   static_cast<int>(sizeof(float));
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

// The self column z = x of row x (dn dx, indices ix, W sw; global index
// gx), one term per pair: a lane's stride-32 partial, then the warp's
// butterfly; lane 0 writes ox[0].  Run by one warp of a large-k block.
template <class F>
__device__ __forceinline__ void self_column(const float* dx, const int* ix,
                                            const float* sw, int k,
                                            int64_t gx, float* ox,
                                            const Params& p) {
  const int lane = threadIdx.x % 32;
  float part = 0.f;
  for (int j = lane; j < k; j += 32) {
    const float dxy = dx[j];
    part = __fadd_rn(
        part, __fmul_rn(KnnSupport<F>::eval(0.f, dxy, dxy, gx > ix[j], p),
                        sw[j]));
  }
  const float self = warp_sum(part);
  if (lane == 0) ox[0] = self;
}

}  // namespace pald::knn
