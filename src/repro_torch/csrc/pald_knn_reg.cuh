// Sparse k-NN PaLD cohesion values past k = 1024 on Hopper, the features
// source in register tiles: for every row x of the neighbor graph the
// (k+1) values of pald_knn.cu's kernel (its note has the passes), with the
// neighbor-to-neighbor distances computed from the neighbors' rows of X.
// Replaces the TPU kernel repro/kernels/pald_knn.py::knn_values_pallas at
// these k; the plain version is repro_torch/core/knn.py::knn_values_tile
// over gather_tile_from_features.  Built as three sources, so that they
// build in parallel: pald_knn_large.cu at widths 8 and 16,
// pald_knn_wide.cu at 32 and kRegMaxWidth = 64, pald_knn_piece.cu past it
// (pieces of 32 features); each entry takes the d whose reg_width is one
// of its widths (takes_width).
//
// What bounds it on the H100: operations.  The row's k x k tile cannot be
// kept (16 MB at k = 2048), so each pass recomputes every entry it reads:
// 2 k^2 (2d + 4) a row for the distances and ~7 k (k+1) for the passes,
// against the bound's k (k-1) / 2 (2d + 4) + 7 k (k+1) (2.76x it at d =
// 8, 3.7x at d = 64).
//
// Design: register tiles.  A block of kRegThreads threads owns one row x
// at a time (rows blockIdx.x, + gridDim.x, ...; at most kBigGrid blocks
// an item, so the W scratch stays 2 k floats a block, as the wrapper
// sizes it for every large-k source).
//   - The metric M and the width DW (8, 16, 32 or 64: d zero-padded,
//     reg_width) are template parameters, picked once on the host: a zero
//     feature adds exactly +0 in every Dist<M>::step (0 * 0 = +0, |0 - 0|
//     = +0, and a running sum that starts at +0 is never -0), so the padded
//     distance and norm are bitwise the plain ones, and the inner loop has
//     no run-time bound or branch.
//   - The row's neighbors stream through shared memory in tiles of
//     kRegTile rows: their DW features, their norm (computed as staged),
//     dn, the index and (pass 2) W, each row a few 16-byte pieces at a
//     pitch of DW + 4 floats (an odd number of 16-byte pieces, so eight
//     threads' stores hit distinct banks).
//   - Pass 1: a thread owns up to J = kPairs<DW> pair rows j (4 at widths
//     8 and 16, 2 at 32, 1 at 64: J DW <= 64 feature registers), holding
//     nbr_j's features, norm, dn[j] and idx[j] in registers, and walks m =
//     0..k-1 in order, reading R = 4 / J of nbr_m's rows at a time as
//     broadcast 16-byte loads: J x R = 4 independent pair sums, all formed
//     before any finish (the finishes hold branches, a root's or a
//     quotient's slow path).  U[j] is one thread's sequential sum, no
//     shuffles, and W[j] is written once (to the block's scratch).  Past
//     kRegThreads * J pairs the rows go in groups, each streaming the
//     tiles again; in a full group (every group but the last) the J sums
//     of a thread interleave with no branch between them, in the last a
//     warp skips the rows it lacks.
//   - The self column: warp 0, as pald_knn.cu's.
//   - Pass 2: a thread owns up to J columns m and walks j in order over
//     the tiles, with pald_knn.cu's two-level sum (a partial of 32 terms
//     added to the total) and its expression for each term.
//   - Past kRegMaxWidth features (knn_feat_piece_kernel) a thread owns one
//     row or column, and the features go in pieces of kPieceWidth: for
//     each tile of kPieceRows staged rows, each piece of theirs is staged,
//     the owned row's piece copied from X to the thread's own slot of
//     shared memory, and kPieceRows pair sums carried in registers from
//     piece to piece in feature order, so each distance takes the same
//     steps in the same order.  The loop over a piece's features is not
//     unrolled (the owned piece is read from shared memory, not held in
//     registers), which keeps the kernel small.  The norms go to the
//     block's scratch (beside W) in a pre-pass.
// Only the order of pass 1's sum differs from pald_knn.cu's (a lane's
// stride-32 partial and a butterfly there), so for a functional whose
// focus is an exact count (drop, split, ignore, and the strict user
// ones) U, W and every value are bitwise its; for a smooth one they agree
// to rounding.  Every width and the pieces sum pass 1 in the same order
// (m ascending), so they give each other's bits.  d(a, c) is bitwise
// d(c, a) (IEEE multiply, add and the difference's magnitude commute), so
// either pass may hold either row.  A chunk of items: blockIdx.y is the
// item, as in pald_knn.cu.
#pragma once

#include <cstdint>
#include <type_traits>

#include "pald_dist.cuh"
#include "pald_knn.cuh"
#include "pald_weights.cuh"

namespace pald::knn {

// pair rows (pass 1) or columns (pass 2) a thread holds at width DW, and
// the staged rows summed at once against them: 4 independent sums
template <int DW>
constexpr int kPairs = DW <= 16 ? 4 : DW <= 32 ? 2 : 1;
template <int DW>
constexpr int kRows = 4 / kPairs<DW>;
static_assert(kRegTile == kRegThreads, "a staged row a thread");
static_assert(kRegThreads == kPieceRows * kPieceWidth / 4,
              "a 16-byte piece of a staged row a thread");

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

// The pair sums of metric M between the J rows a in registers and the R
// staged rows from t (pitch DW + 4 floats), all of them before any finish
template <int M, int DW, int J, int R>
__device__ __forceinline__ void tile_sums(const float (&a)[J][DW],
                                          const float* t,
                                          float (&acc)[J][R]) {
#pragma unroll
  for (int q = 0; q < J; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.f;
#pragma unroll
  for (int f = 0; f < DW / 4; ++f) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 b = reinterpret_cast<const float4*>(t + r * (DW + 4))[f];
#pragma unroll
      for (int q = 0; q < J; ++q) {
        acc[q][r] = Dist<M>::step(acc[q][r], a[q][4 * f], b.x);
        acc[q][r] = Dist<M>::step(acc[q][r], a[q][4 * f + 1], b.y);
        acc[q][r] = Dist<M>::step(acc[q][r], a[q][4 * f + 2], b.z);
        acc[q][r] = Dist<M>::step(acc[q][r], a[q][4 * f + 3], b.w);
      }
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
  constexpr int J = kPairs<DW>, R = kRows<DW>;
  constexpr int P = DW + 4;  // a staged row: features, norm, dn, idx, W
  extern __shared__ __align__(16) float tile[];  // [kRegTile][P]
  const int64_t item = blockIdx.y;
  dn += item * n * k;
  idx += item * n * k;
  out += item * n * (k + 1);
  X += item * xstride;
  const int tid = threadIdx.x, warp = tid / 32;
  float* sw = scratch +
              (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                  2 * k;
  // the pair rows (columns) of a group: every group full but the last
  constexpr int span = kRegThreads * J;

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
    // a group's rows j0 + tid + kRegThreads q (q < J) below j1: their
    // features, norms, dn and indices; live: how many q any lane of this
    // warp holds
    float fr[J][DW], nrm[J], dr[J];
    int ir[J];
    auto own = [&](int j0, int j1) {
      int live = 0;
#pragma unroll
      for (int q = 0; q < J; ++q) {
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
    // Every tile of the row's neighbors in turn (staged with their W for
    // pass 2), each tile's rows R at a time: the pair sums of the owned
    // rows against R staged rows, then term(q, s, g) for each staged row
    // in order (s its norm, dn, index and W; g the distance) and each
    // owned row q, then done(j) for the staged row j.  At J = 4 a warp
    // whose group is full (every q live, every group but the last)
    // interleaves the J sums with no branch between them, and in the last
    // group a warp skips the q it lacks; at J < 4 every warp runs the
    // full sums (an owned row past the group's end is zero and its results
    // are dropped).  Past R = 1 a tile's last R rows may run past its end:
    // those rows are summed (stale shared memory) and skipped.
    auto each_tile = [&](int live, bool with_w, auto&& term, auto&& done) {
      auto rows = [&](auto full, int j0, int mt) {
        for (int r0 = 0; r0 < mt; r0 += R) {
          const float* t = tile + r0 * P;
          float sum[J][R];
          tile_sums<M, DW, J, R>(fr, t, sum);
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            if (R > 1 && r0 + rr >= mt) break;
            const float4 s =
                reinterpret_cast<const float4*>(t + rr * P)[DW / 4];
            const int is = __float_as_int(s.z);
#pragma unroll
            for (int q = 0; q < J; ++q) {
              if constexpr (!decltype(full)::value)
                if (q >= live) break;
              term(q, s, ir[q] == is ? 0.f
                                     : Dist<M>::finish(sum[q][rr], nrm[q],
                                                       s.x));
            }
            done(j0 + r0 + rr);
          }
        }
      };
      for (int j0 = 0; j0 < k; j0 += kRegTile) {
        stage(j0, with_w);
        const int mt = k - j0 < kRegTile ? k - j0 : kRegTile;
        if (J < 4 || live == J)
          rows(std::true_type{}, j0, mt);
        else
          rows(std::false_type{}, j0, mt);
      }
    };

    // pass 1: U[j] and W[j] for every pair (x, nbr_j)
    for (int j0 = 0; j0 < k; j0 += span) {
      const int j1 = j0 + span < k ? j0 + span : k;
      float u[J] = {};
      each_tile(
          own(j0, j1), false,
          [&](int q, float4 s, float g) {
            u[q] = __fadd_rn(u[q], F::focus(s.y, g, dr[q], p));
          },
          [](int) {});
#pragma unroll
      for (int q = 0; q < J; ++q) {
        const int j = j0 + tid + kRegThreads * q;
        if (j < j1) {
          const float uu = __fadd_rn(F::focus(0.f, dr[q], dr[q], p), u[q]);
          sw[j] = uu > 0.f ? __fdiv_rn(1.f, uu) : 0.f;
        }
      }
    }
    __syncthreads();  // every W in the scratch

    float* ox = out + x * static_cast<int64_t>(k + 1);
    if (warp == 0) self_column<F>(dx, ix, sw, k, gx, ox, p);

    // pass 2: the neighbor columns z = nbr_m, each thread its columns,
    // each a two-level sum over j in order
    for (int m0 = 0; m0 < k; m0 += span) {
      const int m1 = m0 + span < k ? m0 + span : k;
      float total[J] = {}, acc[J] = {};
      each_tile(
          own(m0, m1), true,
          [&](int q, float4 s, float g) {
            const bool ow = gx > __float_as_int(s.z);
            const float v = KnnSupport<F>::eval(dr[q], g, s.y, ow, p);
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v, s.w));
          },
          [&](int j) {
            if ((j & 31) == 31) {
#pragma unroll
              for (int q = 0; q < J; ++q) {
                total[q] = __fadd_rn(total[q], acc[q]);
                acc[q] = 0.f;
              }
            }
          });
#pragma unroll
      for (int q = 0; q < J; ++q) {
        const int m = m0 + tid + kRegThreads * q;
        if (m < m1) ox[1 + m] = __fadd_rn(total[q], acc[q]);
      }
    }
  }
}

// The features source past k = 1024 and past kRegMaxWidth features for
// family F and metric M, the features in pieces of kPieceWidth (arguments
// as knn_feat_reg_kernel's; the block's scratch holds W, then the norms).
template <class F, int M>
__global__ void __launch_bounds__(kRegThreads, 2)
knn_feat_piece_kernel(const float* __restrict__ dn,
                      const float* __restrict__ X, int64_t d,
                      int64_t xstride, const int* __restrict__ idx,
                      float* __restrict__ out, int64_t n, int k,
                      int64_t row_off, bool nbr, float* scratch, Params p) {
  constexpr int PW = kPieceWidth, T = kPieceRows;
  constexpr int P = PW + 4;  // a staged row: a piece, norm, dn, idx, W
  // [T][P] staged rows, then [kRegThreads][P] each thread's owned piece
  extern __shared__ __align__(16) float tile[];
  const int64_t item = blockIdx.y;
  dn += item * n * k;
  idx += item * n * k;
  out += item * n * (k + 1);
  X += item * xstride;
  const int tid = threadIdx.x, warp = tid / 32;
  float* sw = scratch +
              (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                  2 * k;
  float* snrm = sw + k;
  const int pieces = static_cast<int>((d + PW - 1) / PW);
  const float4* tile4 = reinterpret_cast<const float4*>(tile);
  // this thread's slot: its owned row's piece, then the tile's sums
  float* slot = tile + (T + tid) * P;
  float4* mine = reinterpret_cast<float4*>(slot);

  for (int64_t x = blockIdx.x; x < n; x += gridDim.x) {
    const float* dx = dn + x * k;
    const int* ix = idx + x * k;
    const int64_t gx = row_off + x;
    auto src = [&](int j) -> const float* {
      return X + (nbr ? x * k + j : static_cast<int64_t>(ix[j])) * d;
    };
    // the neighbors' norms, each a loop over its features in order (the
    // row-norm pre-pass's steps; manhattan has none), once the previous
    // row's passes are done with the scratch
    __syncthreads();
    if constexpr (Dist<M>::kNorms) {
      for (int j = tid; j < k; j += kRegThreads) {
        const float* fj = src(j);
        float s = 0.f;
        for (int64_t f = 0; f < d; ++f)
          s = Dist<pald::kSqEuclidean>::step(s, __ldg(fj + f), __ldg(fj + f));
        snrm[j] = Dist<M>::norm(s);
      }
    }
    __syncthreads();
    auto norm = [&](int j) { return Dist<M>::kNorms ? snrm[j] : 0.f; };
    // stage piece pc of neighbors j0.. (a 16-byte piece a thread), with
    // their norm, dn, index and W at the first piece, once the previous
    // piece is free
    auto stage = [&](int j0, int pc, bool with_w) {
      __syncthreads();
      const int r = tid / (PW / 4), f4 = tid % (PW / 4);
      const int j = j0 + r;
      const int64_t f0 = static_cast<int64_t>(pc) * PW + 4 * f4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < k) {
        const float* s = src(j);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (f0 + i < d) v[i] = __ldg(s + f0 + i);
        if (pc == 0 && f4 == 0)
          reinterpret_cast<float4*>(tile + r * P)[PW / 4] =
              make_float4(norm(j), dx[j], __int_as_float(ix[j]),
                          with_w ? sw[j] : 0.f);
      }
      reinterpret_cast<float4*>(tile + r * P)[f4] =
          make_float4(v[0], v[1], v[2], v[3]);
      __syncthreads();
    };
    // the owned row j's piece pc into this thread's slot (odd 16-byte
    // pitch: eight threads' 16-byte accesses hit distinct banks), zero past
    // d (and for no row)
    auto own_piece = [&](int j, int pc) {
      const float* s = j < k ? src(j) : X;
      const int64_t f0 = static_cast<int64_t>(pc) * PW;
      for (int f = 0; f < PW / 4; ++f) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t fi = f0 + 4 * f + i;
          v[i] = j < k && fi < d ? __ldg(s + fi) : 0.f;
        }
        mine[f] = make_float4(v[0], v[1], v[2], v[3]);
      }
    };
    // the T pair sums of the owned row and the staged tile at j0, carried
    // through every piece in feature order, then left in the thread's
    // slot (so the terms after them run as a loop, not unrolled T times)
    auto tile_sums_pieces = [&](int j, int j0, bool with_w) {
      float acc[T];
#pragma unroll
      for (int r = 0; r < T; ++r) acc[r] = 0.f;
      for (int pc = 0; pc < pieces; ++pc) {
        stage(j0, pc, with_w);
        own_piece(j, pc);
#pragma unroll 1
        for (int f = 0; f < PW / 4; ++f) {
          const float4 a = mine[f];
#pragma unroll
          for (int r = 0; r < T; ++r) {
            const float4 b = tile4[r * (P / 4) + f];
            acc[r] = Dist<M>::step(acc[r], a.x, b.x);
            acc[r] = Dist<M>::step(acc[r], a.y, b.y);
            acc[r] = Dist<M>::step(acc[r], a.z, b.z);
            acc[r] = Dist<M>::step(acc[r], a.w, b.w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < T; ++r) slot[r] = acc[r];
    };

    // pass 1: U[j] and W[j], a pair row a thread
    for (int j0 = 0; j0 < k; j0 += kRegThreads) {
      const int j = j0 + tid;
      const bool ok = j < k;
      const float nj = ok ? norm(j) : 0.f, dj = ok ? dx[j] : 0.f;
      const int ij = ok ? ix[j] : -1;
      float u = 0.f;
      for (int m0 = 0; m0 < k; m0 += T) {
        const int mt = k - m0 < T ? k - m0 : T;
        tile_sums_pieces(j, m0, false);
        for (int r = 0; r < mt; ++r) {
          const float4 s = tile4[r * (P / 4) + PW / 4];
          const float g = ij == __float_as_int(s.z)
                              ? 0.f
                              : Dist<M>::finish(slot[r], nj, s.x);
          u = __fadd_rn(u, F::focus(s.y, g, dj, p));
        }
      }
      if (ok) {
        const float uu = __fadd_rn(F::focus(0.f, dj, dj, p), u);
        sw[j] = uu > 0.f ? __fdiv_rn(1.f, uu) : 0.f;
      }
    }
    __syncthreads();  // every W in the scratch

    float* ox = out + x * static_cast<int64_t>(k + 1);
    if (warp == 0) self_column<F>(dx, ix, sw, k, gx, ox, p);

    // pass 2: the neighbor columns z = nbr_m, a column a thread
    for (int m0 = 0; m0 < k; m0 += kRegThreads) {
      const int m = m0 + tid;
      const bool ok = m < k;
      const float nm = ok ? norm(m) : 0.f, dm = ok ? dx[m] : 0.f;
      const int im = ok ? ix[m] : -1;
      float total = 0.f, acc = 0.f;
      for (int j0 = 0; j0 < k; j0 += T) {
        const int jt = k - j0 < T ? k - j0 : T;
        tile_sums_pieces(m, j0, true);
        for (int r = 0; r < jt; ++r) {
          const float4 s = tile4[r * (P / 4) + PW / 4];
          const int ij = __float_as_int(s.z);
          const float g = im == ij ? 0.f : Dist<M>::finish(slot[r], nm, s.x);
          const float v = KnnSupport<F>::eval(dm, g, s.y, gx > ij, p);
          acc = __fadd_rn(acc, __fmul_rn(v, s.w));
          if (((j0 + r) & 31) == 31) {
            total = __fadd_rn(total, acc);
            acc = 0.f;
          }
        }
      }
      if (ok) ox[1 + m] = __fadd_rn(total, acc);
    }
  }
}

// What a launch of the features source past k = 1024 takes
struct RegArgs {
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
};

// Launch kern over a's rows, one grid per kMaxItems items: (min(n,
// kBigGrid) row blocks, the grid's items), smem bytes of shared memory
template <class Kernel>
int launch_reg_grids(Kernel kern, int smem, const RegArgs& a) {
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned rows =
      static_cast<unsigned>(a.n < kBigGrid ? a.n : kBigGrid);
  for (int64_t i0 = 0; i0 < a.items; i0 += kMaxItems) {
    const int64_t b = a.items - i0 < kMaxItems ? a.items - i0 : kMaxItems;
    const int64_t e = i0 * a.n * a.k;
    kern<<<dim3(rows, static_cast<unsigned>(b)), kRegThreads, smem,
           a.stream>>>(a.dn + e, a.X + i0 * a.xstride, a.d, a.xstride,
                       a.idx + e, a.out + i0 * a.n * (a.k + 1), a.n, a.k,
                       a.row_off, a.nbr, a.scratch, a.p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// the launch of family F, metric M at width DW (0: the pieces)
template <class F, int M, int DW>
int launch_reg(const RegArgs& a) {
  if constexpr (DW == 0)
    return launch_reg_grids(knn_feat_piece_kernel<F, M>,
                            reg_smem_bytes(kRegMaxWidth + 1), a);
  else
    return launch_reg_grids(knn_feat_reg_kernel<F, M, DW>,
                            reg_smem_bytes(DW), a);
}

// the launch at the first of a source's widths W, Rest... that is d's
// (the last when none is; 0: the pieces)
template <class F, int M, int W, int... Rest>
int launch_width(const RegArgs& a) {
  if constexpr (sizeof...(Rest) == 0)
    return launch_reg<F, M, W>(a);
  else
    return reg_width(a.d) == W ? launch_reg<F, M, W>(a)
                               : launch_width<F, M, Rest...>(a);
}

// the launch of family F at a source's widths, the metric picked once
template <int... Widths>
struct RegLaunch {
  const RegArgs& a;

  template <class F>
  struct PerMetric {
    const RegArgs& a;
    template <int M>
    int operator()() const {
      return launch_width<F, M, Widths...>(a);
    }
  };

  template <class F>
  int operator()() const {
    return pald::dispatch_metric(a.metric, PerMetric<F>{a});
  }
};

// whether a source built at widths Widths... (0: the pieces) takes d
// features: reg_width(d) is one of them, or past kRegMaxWidth the pieces
template <int... Widths>
constexpr bool takes_width(int64_t d) {
  return d >= 0 &&
         ((Widths == 0 ? d > kRegMaxWidth : reg_width(d) == Widths) || ...);
}

// A source's entry: the d its widths take; cudaErrorInvalidValue for an
// argument out of range or an unknown family or metric.
template <int... Widths>
int reg_entry(const RegArgs& a, int wid) {
  if (a.n < 1 || a.k < 1 || !takes_width<Widths...>(a.d) ||
      a.scratch == nullptr || a.row_off < 0 || a.items < 1 ||
      a.xstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(wid, RegLaunch<Widths...>{a});
}

}  // namespace pald::knn
