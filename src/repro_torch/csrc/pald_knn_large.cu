// Sparse k-NN PaLD cohesion values past k = 1024 on Hopper, the features
// source at feature widths d <= 16 (kRegMaxD): for every row x of the
// neighbor graph the (k+1) values of pald_knn.cu's kernel (its note has
// the passes), with the neighbor-to-neighbor distances computed from the
// neighbors' rows of X.  Replaces the TPU kernel
// repro/kernels/pald_knn.py::knn_values_pallas (at these k and widths;
// pald_knn.cu's knn_feat_big_kernel takes d > 16); the plain version is
// repro_torch/core/knn.py::knn_values_tile over
// gather_tile_from_features.
//
// What bounds it on the H100: operations.  The row's k x k tile cannot be
// kept (16 MB at k = 2048), so each pass recomputes every entry it reads:
// 2 k^2 (2d + 4) a row for the distances and ~7 k (k+1) for the passes,
// against the bound's k (k-1) / 2 (2d + 4) + 7 k (k+1) (2.76x it at d =
// 8).  The variant of one row a block of 32 warps that this replaces ran
// each pair as one lane's loop over a run-time d, reading both feature
// rows a float at a time, both indices and both norms, under a run-time
// switch on the metric: its load/store pipe, ~20 operations a pair, set
// the pace, 22-29x the bound.
//
// Design: register tiles.  A block of kRegThreads threads owns one row x
// at a time (rows blockIdx.x, + gridDim.x, ...; at most kBigGrid blocks
// an item, so the W scratch stays 2 k floats a block, as the wrapper
// sizes it for every large-k source).
//   - The metric M and the width DW (8 or 16: d zero-padded, reg_width)
//     are template parameters, picked once on the host: a zero feature
//     adds exactly +0 in every Dist<M>::step (0 * 0 = +0, |0 - 0| = +0, and
//     a running sum that starts at +0 is never -0), so the padded distance
//     and norm are bitwise the plain ones, and the inner loop has no
//     run-time bound or branch.
//   - The row's neighbors stream through shared memory in tiles of
//     kRegTile rows: their DW features, their norm (computed as staged),
//     dn, the index and (pass 2) W, each row a few 16-byte pieces.
//   - Pass 1: a thread owns up to kRegPairs pair rows j, holding nbr_j's
//     features, norm, dn[j] and idx[j] in registers, and walks m = 0..k-1
//     in order, reading nbr_m's row as broadcast 16-byte loads: U[j] is one
//     thread's sequential sum, no shuffles, and W[j] is written once (to
//     the block's scratch).  Past kRegThreads * kRegPairs pairs the rows
//     go in groups, each streaming the tiles again; in a full group (every
//     group but the last) the kRegPairs sums of a thread interleave with
//     no branch between them, in the last a warp skips the rows it lacks.
//   - The self column: warp 0, as pald_knn.cu's.
//   - Pass 2: a thread owns up to kRegPairs columns m and walks j in order
//     over the tiles, with pald_knn.cu's two-level sum (a partial of 32
//     terms added to the total) and its expression for each term.
// Only the order of pass 1's sum differs from pald_knn.cu's (a lane's
// stride-32 partial and a butterfly there), so for a functional whose
// focus is an exact count (drop, split, ignore, and the strict user
// ones) U, W and every value are bitwise its; for a smooth one they agree
// to rounding.  d(a, c) is bitwise d(c, a) (IEEE multiply, add and the
// difference's magnitude commute), so either pass may hold either row.
// A chunk of items: blockIdx.y is the item, as in pald_knn.cu.
#include <cstdint>
#include <type_traits>

#include "pald_dist.cuh"
#include "pald_knn.cuh"
#include "pald_weights.cuh"

namespace {

using pald::Dist;
using pald::Params;
using pald::knn::kBigGrid;
using pald::knn::KnnSupport;
using pald::knn::kMaxItems;
using pald::knn::kRegMaxD;
using pald::knn::kRegThreads;
using pald::knn::kRegTile;
using pald::knn::warp_sum;

constexpr int kRegPairs = 4;  // pair rows (pass 1) or columns (pass 2) a
                              // thread holds
static_assert(kRegTile == kRegThreads, "a staged row a thread");

// a row's norm term from its DW features (the row-norm pre-pass's steps;
// manhattan has none)
template <int M, int DW>
__device__ __forceinline__ float norm_of(const float (&f)[DW]) {
  float s = 0.f;
  if constexpr (M != pald::kManhattan) {
#pragma unroll
    for (int i = 0; i < DW; ++i)
      s = Dist<pald::kSqEuclidean>::step(s, f[i], f[i]);
  }
  return M == pald::kCosine ? Dist<pald::kCosine>::norm(s) : s;
}

// The pair sums of metric M between the kRegPairs rows a in registers and
// the staged row t, all of them before any finish: the finishes hold
// branches (a root's or a quotient's slow path), and the sums, kept apart
// from them, interleave kRegPairs independent chains
template <int M, int DW, int J>
__device__ __forceinline__ void tile_sums(const float (&a)[J][DW],
                                          const float* t, float (&acc)[J]) {
#pragma unroll
  for (int q = 0; q < J; ++q) acc[q] = 0.f;
#pragma unroll
  for (int f = 0; f < DW / 4; ++f) {
    const float4 b = reinterpret_cast<const float4*>(t)[f];
#pragma unroll
    for (int q = 0; q < J; ++q) {
      acc[q] = Dist<M>::step(acc[q], a[q][4 * f], b.x);
      acc[q] = Dist<M>::step(acc[q], a[q][4 * f + 1], b.y);
      acc[q] = Dist<M>::step(acc[q], a[q][4 * f + 2], b.z);
      acc[q] = Dist<M>::step(acc[q], a[q][4 * f + 3], b.w);
    }
  }
}

// The features source past k = 1024 at width DW for family F and metric
// M: each block its rows in turn (X (., d), or with nbr the (n, k, d)
// block of each row's neighbor rows; row x's global index row_off + x;
// item y's X xstride elements past the previous item's).
template <class F, int M, int DW>
__global__ void __launch_bounds__(kRegThreads, 2)
knn_feat_reg_kernel(const float* __restrict__ dn,
                    const float* __restrict__ X, int64_t d, int64_t xstride,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int64_t n, int k, int64_t row_off, bool nbr,
                    float* scratch, Params p) {
  constexpr int P = DW + 4;  // a staged row: features, norm, dn, idx, W
  extern __shared__ __align__(16) float tile[];  // [kRegTile][P]
  const int64_t item = blockIdx.y;
  dn += item * n * k;
  idx += item * n * k;
  out += item * n * (k + 1);
  X += item * xstride;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* sw = scratch +
              (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                  2 * k;
  // the pair rows (columns) of a group: every group full but the last
  constexpr int span = kRegThreads * kRegPairs;

  for (int64_t x = blockIdx.x; x < n; x += gridDim.x) {
    const float* dx = dn + x * k;
    const int* ix = idx + x * k;
    const int64_t gx = row_off + x;
    // neighbor j's features, zero past d
    auto load = [&](int j, float (&f)[DW]) {
      const float* s =
          X + (nbr ? x * k + j : static_cast<int64_t>(ix[j])) * d;
#pragma unroll
      for (int i = 0; i < DW; ++i) f[i] = i < d ? __ldg(s + i) : 0.f;
    };
    // stage neighbors j0.. (one a thread) once the previous tile is free
    auto stage = [&](int j0, bool with_w) {
      __syncthreads();
      const int j = j0 + tid;
      if (j < k) {
        float f[DW];
        load(j, f);
        float4* t = reinterpret_cast<float4*>(tile + tid * P);
#pragma unroll
        for (int q = 0; q < DW / 4; ++q)
          t[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2],
                             f[4 * q + 3]);
        t[DW / 4] = make_float4(norm_of<M, DW>(f), dx[j],
                                __int_as_float(ix[j]),
                                with_w ? sw[j] : 0.f);
      }
      __syncthreads();
    };
    // a group's rows j0 + tid + kRegThreads q (q < kRegPairs) below j1:
    // their features, norms, dn and indices; live: how many q any lane
    // of this warp holds
    float fr[kRegPairs][DW], nrm[kRegPairs], dr[kRegPairs];
    int ir[kRegPairs];
    auto own = [&](int j0, int j1) {
      int live = 0;
#pragma unroll
      for (int q = 0; q < kRegPairs; ++q) {
        const int j = j0 + tid + kRegThreads * q;
        if (j < j1) {
          load(j, fr[q]);
        } else {
#pragma unroll
          for (int i = 0; i < DW; ++i) fr[q][i] = 0.f;
        }
        nrm[q] = norm_of<M, DW>(fr[q]);
        dr[q] = j < j1 ? dx[j] : 0.f;
        ir[q] = j < j1 ? ix[j] : -1;
        live += j0 + 32 * warp + kRegThreads * q < j1;
      }
      return live;
    };

    // pass 1: U[j] and W[j] for every pair (x, nbr_j)
    for (int j0 = 0; j0 < k; j0 += span) {
      const int j1 = j0 + span < k ? j0 + span : k;
      const int live = own(j0, j1);
      float u[kRegPairs] = {};
      // one tile of mt rows m; full: every q live in this warp, so the
      // kRegPairs sums interleave with no branch between them
      auto tile_rows = [&](auto full, int mt) {
        for (int r = 0; r < mt; ++r) {
          const float* t = tile + r * P;
          const float4 s = reinterpret_cast<const float4*>(t)[DW / 4];
          const int im = __float_as_int(s.z);
          float sum[kRegPairs];
          tile_sums<M, DW>(fr, t, sum);
#pragma unroll
          for (int q = 0; q < kRegPairs; ++q) {
            if constexpr (!decltype(full)::value)
              if (q >= live) break;
            const float g =
                ir[q] == im ? 0.f : Dist<M>::finish(sum[q], nrm[q], s.x);
            u[q] = __fadd_rn(u[q], F::focus(s.y, g, dr[q], p));
          }
        }
      };
      for (int m0 = 0; m0 < k; m0 += kRegTile) {
        stage(m0, false);
        const int mt = k - m0 < kRegTile ? k - m0 : kRegTile;
        if (live == kRegPairs)
          tile_rows(std::true_type{}, mt);
        else
          tile_rows(std::false_type{}, mt);
      }
#pragma unroll
      for (int q = 0; q < kRegPairs; ++q) {
        const int j = j0 + tid + kRegThreads * q;
        if (j < j1) {
          const float uu = __fadd_rn(F::focus(0.f, dr[q], dr[q], p), u[q]);
          sw[j] = uu > 0.f ? __fdiv_rn(1.f, uu) : 0.f;
        }
      }
    }
    __syncthreads();  // every W in the scratch

    float* ox = out + x * static_cast<int64_t>(k + 1);
    if (warp == 0) {  // the self column: z = x, one term per pair
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

    // pass 2: the neighbor columns z = nbr_m, each thread its columns
    for (int m0 = 0; m0 < k; m0 += span) {
      const int m1 = m0 + span < k ? m0 + span : k;
      const int live = own(m0, m1);
      float total[kRegPairs] = {}, acc[kRegPairs] = {};
      // one tile of jt rows j from j0, as pass 1's
      auto tile_rows = [&](auto full, int j0, int jt) {
        for (int r = 0; r < jt; ++r) {
          const float* t = tile + r * P;
          const float4 s = reinterpret_cast<const float4*>(t)[DW / 4];
          const int ij = __float_as_int(s.z);
          const bool ow = gx > ij;
          float sum[kRegPairs];
          tile_sums<M, DW>(fr, t, sum);
#pragma unroll
          for (int q = 0; q < kRegPairs; ++q) {
            if constexpr (!decltype(full)::value)
              if (q >= live) break;
            const float g =
                ir[q] == ij ? 0.f : Dist<M>::finish(sum[q], nrm[q], s.x);
            const float v = KnnSupport<F>::eval(dr[q], g, s.y, ow, p);
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v, s.w));
          }
          if (((j0 + r) & 31) == 31) {
#pragma unroll
            for (int q = 0; q < kRegPairs; ++q) {
              total[q] = __fadd_rn(total[q], acc[q]);
              acc[q] = 0.f;
            }
          }
        }
      };
      for (int j0 = 0; j0 < k; j0 += kRegTile) {
        stage(j0, true);
        const int jt = k - j0 < kRegTile ? k - j0 : kRegTile;
        if (live == kRegPairs)
          tile_rows(std::true_type{}, j0, jt);
        else
          tile_rows(std::false_type{}, j0, jt);
      }
#pragma unroll
      for (int q = 0; q < kRegPairs; ++q) {
        const int m = m0 + tid + kRegThreads * q;
        if (m < m1) ox[1 + m] = __fadd_rn(total[q], acc[q]);
      }
    }
  }
}

// the launch for family F: the metric, then the width, once
struct RegLaunch {
  const float* dn;
  const float* X;
  int64_t d, xstride;
  const int* idx;
  float* out;
  int64_t n;
  int k, metric;
  int64_t row_off;
  bool nbr;
  int64_t items;
  float* scratch;
  Params p;
  cudaStream_t stream;

  template <class F, int M, int DW>
  int launch() const {
    const auto kern = knn_feat_reg_kernel<F, M, DW>;
    const size_t smem = pald::knn::reg_smem_bytes(DW);
    const unsigned rows = static_cast<unsigned>(n < kBigGrid ? n : kBigGrid);
    for (int64_t i0 = 0; i0 < items; i0 += kMaxItems) {
      const int64_t b = items - i0 < kMaxItems ? items - i0 : kMaxItems;
      const int64_t e = i0 * n * k;
      kern<<<dim3(rows, static_cast<unsigned>(b)), kRegThreads, smem,
             stream>>>(dn + e, X + i0 * xstride, d, xstride, idx + e,
                       out + i0 * n * (k + 1), n, k, row_off, nbr, scratch,
                       p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  }

  template <class F>
  struct PerMetric {
    const RegLaunch& o;
    template <int M>
    int operator()() const {
      return pald::knn::reg_width(o.d) == 8 ? o.launch<F, M, 8>()
                                            : o.launch<F, M, 16>();
    }
  };

  template <class F>
  int operator()() const {
    return pald::dispatch_metric(metric, PerMetric<F>{*this});
  }
};

}  // namespace

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
  if (n < 1 || k < 1 || d < 0 || d > kRegMaxD || scratch == nullptr ||
      row_off < 0 || items < 1 || xstride < 0 ||
      metric < pald::kSqEuclidean || metric > pald::kManhattan)
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(
      wid, RegLaunch{dn, X, d, xstride, idx, out, n, k, metric, row_off,
                     nbr != 0, items, scratch, {p0, p1},
                     static_cast<cudaStream_t>(stream)});
}

