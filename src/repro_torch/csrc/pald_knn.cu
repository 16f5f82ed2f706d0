// Sparse k-NN PaLD cohesion on Hopper: for every row x of the neighbor
// graph, the (k+1) values [self, nbr_0, ..., nbr_{k-1}] of
//
//     U[j]   = focus(0, dn[j], dn[j]) + sum_m focus(dn[m], g(j, m), dn[j])
//     W[j]   = U[j] > 0 ? 1 / U[j] : 0
//     out[0] = sum_j support(0, dn[j], dn[j], x > idx[j]) W[j]
//     out[1+m] = sum_j support(dn[m], g(j, m), dn[j], x > idx[j]) W[j]
//
// from dn (n, k) neighbor distances, idx (n, k) neighbor indices and the
// neighbor-to-neighbor distances g(j, m) = d(nbr_j, nbr_m).  Replaces the
// TPU kernel repro/kernels/pald_knn.py::knn_values_pallas on the real k
// (no lane padding); the plain version is
// repro_torch/core/knn.py::knn_values_tile.  For a functional with a share
// (soft, or a user functional that declares one) the support is
// share(own, other) * focus(own, other, pair), the plain version's reuse of
// its focus cube, recomputed here.
//
// One kernel body (values_passes), three sources of g, one entry each:
//   - pald_knn_values_f32: a gathered (n, k, k) cube in device memory, the
//     direct counterpart of knn_values_pallas (bound by reading the cube);
//   - pald_knn_values_features_f32: the row's k neighbor feature rows (X
//     (n, d) and idx): the warp stages them in shared memory (or, past
//     16 KB of them, reads them from X through L1/L2), computes their
//     norms, and, for k <= 64, the k x k tile once: the upper triangle two
//     rows a step (row f's entries and row k-2-f's: k of them, so the warp
//     stays full), each entry written to (a, c) and (c, a), since d(a, c)
//     is bitwise d(c, a) for all four metrics.  Past k = 64 each pass
//     computes every entry where it reads it.  Every entry takes
//     pald_dist.cuh's steps, so it is bitwise gather_tile_from_features's
//     (the same-index entries, the diagonal, exactly 0);
//   - pald_knn_values_distances_f32: D (n, n) and idx, D[idx_j, idx_m]
//     read straight, as gather_tile_from_distances gathers it.
// The features entry also takes the global index of the first row (a
// shard's rows are a slice of the graph: the index tiebreak compares
// global indices), and, in place of X, an (n, k, d) block of each row's
// neighbor feature rows (a ring shard holds no whole X,
// repro_torch/core/distributed_knn.py); the same rows give the same bits.
// Neither of the last two writes any (n, k, k) array: what the main path
// moves is X's rows (through L2), dn, idx and the (n, k+1) output.  What
// bounds them on the H100: operations, the tile's k (k-1) / 2 distances
// (2d + 4 each) and the passes' ~7 k (k+1) per row.
//
// A chunk of items (the engine's batch= chunks, the reference's vmap): the
// features and D entries take `items` graphs of n rows, one after another
// (dn, idx (items, n, k), the output (items, n, k+1)), each with its own X
// or D `xstride` / `dstride` elements past the previous item's; blockIdx.y
// is the item, and every index (and the row offset) stays within its
// item.  Each item's blocks run exactly what a one-item grid's do, so a
// chunk's values are bitwise its items' one at a time.  Only the kChunk
// variants (a chunk of more than one item) take the item, so one item runs
// code without the item offsets.  A grid holds up to 65535 items
// (gridDim.y); past that the host issues one grid per 65535.  The cube
// source and the neighbor-row block take one item.
//
// Design of the passes.  One warp per row, four rows per block of 128
// threads; the row's dn, W and idx sit in shared memory.  Pass 1 walks the
// pairs j in order: lane l sums the focus terms of m = l, l + 32, ..., a
// butterfly of shuffles adds the 32 partial sums (every lane ends with the
// same bits), and lane 0 stores W[j].  Pass 2 gives each lane the column m
// = l + 32t and walks j in order, summing 32 terms into a partial and the
// partial into the total (two-level, as the dense kernels do); the self
// column is one term per j, summed over the lanes as in pass 1.  The three
// sources run the same passes in the same order, so on the same g they
// give bitwise the same values.  Every weight is pald_weights.cuh's,
// bitwise torch's; only the order of the sums differs from the plain
// version, so the smooth families' U (and every value) agree to rounding,
// and the exact families' U bitwise.  64-bit offsets (n k^2 passes 2^31 at
// k = 32 past n = 2.1e6).
//
// Past k = kLargeK = 1024, the large-k variant (one item or a chunk;
// beside the kernels of k <= 1024, which it leaves as they are).  A row's
// dn, W and idx (12 B k) no longer fit four rows to a block in shared
// memory for every k, so the row's state leaves it: dn and idx are read
// where they lie (read-only, through L1/L2), and W (and the D source's
// sorted positions past 64 KB of them) go to a global scratch of 2 k
// float32 a block that the wrapper allocates.  A grid has at most
// kBigGrid row blocks (each takes rows blockIdx.x, + gridDim.x, ...), so
// the scratch is 8 KB k an item at most (32 MB at k = 4096): that bounds
// the variant's peak above its outputs.
//   - The cube source runs all kBigWarps warps of a block on its one row:
//     pass 1 deals the pairs j to the warps in turn (each U[j] still one
//     warp's sum), warp 0 sums the self column, and pass 2 deals the
//     column groups m0 to the warps; a block barrier parts the passes.
//     Each value is the same expression in the same order as in the
//     one-warp rows, so it gives their bits at every k.
//   - The D source sweeps the row's tile once (knn_dist_sweep_kernel's
//     note): each entry of D it needs read once, in ascending column
//     order, where the one-warp rows read each twice in the neighbors'
//     order.  Its pass 1 sums over the sorted columns, so its values are
//     bitwise the others' for a functional whose focus is an exact count
//     and within rounding for a smooth one; pass 2 keeps their order.
//   - The features source is the register tiles' (pald_knn_reg.cuh),
//     entries of their own in pald_knn_large.cu, pald_knn_wide.cu and
//     pald_knn_piece.cu.
#include <cstdint>

#include "pald_dist.cuh"
#include "pald_knn.cuh"
#include "pald_weights.cuh"

namespace {

using pald::Dist;
using pald::Params;
using pald::knn::kBigGrid;
using pald::knn::KnnSupport;
using pald::knn::kLargeK;
using pald::knn::kMaxItems;
using pald::knn::self_column;
using pald::knn::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileMaxK = 64;          // the k x k tile in shared memory
constexpr int kStageBytes = 16 << 10;  // neighbor rows staged per warp
constexpr int kBigWarps = 32;          // large-k: the warps on one row
constexpr int kBigThreads = 32 * kBigWarps;

// the row's shared memory: dn, W, idx (and the features source's norms,
// tile and staged rows after them)
struct RowSmem {
  float* sd;
  float* sw;
  int* si;
};

// Load row x's dn and idx into its warp's shared memory.
__device__ __forceinline__ RowSmem load_row(float* base, const float* dn,
                                            const int* idx, int64_t x, int k,
                                            int lane) {
  RowSmem r{base, base + k, reinterpret_cast<int*>(base + 2 * k)};
  for (int j = lane; j < k; j += 32) {
    r.sd[j] = dn[x * k + j];
    r.si[j] = idx[x * k + j];
  }
  __syncwarp();
  return r;
}

// Passes 1 and 2 of row x (global index gx, which the index tiebreak
// compares) with g(j, m) = get(j, m); writes out[x].
template <class F, class Get>
__device__ __forceinline__ void values_passes(const Get& get,
                                              const RowSmem& r, int64_t x,
                                              int64_t gx, int k, int lane,
                                              const Params& p, float* out) {
  const float* sd = r.sd;
  float* sw = r.sw;
  const int* si = r.si;
  // pass 1: U[j] and W[j] for every pair (x, nbr_j)
  for (int j = 0; j < k; ++j) {
    const float dxy = sd[j];
    float part = 0.f;
    for (int m = lane; m < k; m += 32)
      part = __fadd_rn(part, F::focus(sd[m], get(j, m), dxy, p));
    const float u = __fadd_rn(F::focus(0.f, dxy, dxy, p), warp_sum(part));
    if (lane == 0) sw[j] = u > 0.f ? __fdiv_rn(1.f, u) : 0.f;
  }
  __syncwarp();

  // the self column: z = x, one term per pair
  float part = 0.f;
  for (int j = lane; j < k; j += 32) {
    const float dxy = sd[j];
    const bool ow = gx > si[j];
    part = __fadd_rn(part, __fmul_rn(KnnSupport<F>::eval(0.f, dxy, dxy, ow, p),
                                     sw[j]));
  }
  const float self = warp_sum(part);
  float* ox = out + x * static_cast<int64_t>(k + 1);
  if (lane == 0) ox[0] = self;

  // pass 2: the neighbor columns z = nbr_m, lane l taking m = l + 32t
  for (int m0 = 0; m0 < k; m0 += 32) {
    const int m = m0 + lane;
    if (m >= k) break;
    const float dxz = sd[m];
    float total = 0.f, acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float t =
          KnnSupport<F>::eval(dxz, get(j, m), sd[j], gx > si[j], p);
      acc = __fadd_rn(acc, __fmul_rn(t, sw[j]));
      if ((j & 31) == 31) {
        total = __fadd_rn(total, acc);
        acc = 0.f;
      }
    }
    ox[1 + m] = __fadd_rn(total, acc);
  }
}

// source 1: the gathered cube g (n, k, k)
template <class F>
__global__ void __launch_bounds__(kThreads)
knn_cube_kernel(const float* __restrict__ dn, const float* __restrict__ g,
                const int* __restrict__ idx, float* __restrict__ out,
                int64_t n, int k, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (x >= n) return;  // a whole warp: no block-wide barrier below
  const RowSmem r = load_row(smem + warp * 3 * k, dn, idx, x, k, lane);
  const float* gx = g + x * static_cast<int64_t>(k) * k;
  values_passes<F>(
      [&](int j, int m) { return gx[static_cast<int64_t>(j) * k + m]; }, r,
      x, x, k, lane, p, out);
}

// source 2: D (ldd columns), D[idx_j, idx_m]; item y's D dstride elements
// past the previous item's
template <class F, bool kChunk>
__global__ void __launch_bounds__(kThreads)
knn_dist_kernel(const float* __restrict__ dn, const float* __restrict__ D,
                int64_t ldd, int64_t dstride, const int* __restrict__ idx,
                float* __restrict__ out, int64_t n, int k, Params p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.y;
    dn += item * n * k;
    idx += item * n * k;
    out += item * n * (k + 1);
    D += item * dstride;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (x >= n) return;
  const RowSmem r = load_row(smem + warp * 3 * k, dn, idx, x, k, lane);
  const int* si = r.si;
  values_passes<F>(
      [&](int j, int m) {
        return __ldg(D + static_cast<int64_t>(si[j]) * ldd + si[m]);
      },
      r, x, x, k, lane, p, out);
}

// the tile's pitch: odd, so a column of 32 consecutive rows hits 32 banks
__host__ __device__ constexpr int tile_pitch(int k) { return k | 1; }

// d(a, c) of metric M from the two rows' features and norm terms:
// pald_dist.cuh's steps and finish
template <int M>
__device__ __forceinline__ float feat_dist(const float* fa, const float* fc,
                                           int64_t d, float na, float nb) {
  float acc = 0.f;
  for (int64_t f = 0; f < d; ++f) acc = Dist<M>::step(acc, fa[f], fc[f]);
  return Dist<M>::finish(acc, na, nb);
}

// the same for a metric id known at run time (one branch a distance, the
// same in every lane): the kernel is compiled once per family, not once
// per family and metric
__device__ __forceinline__ float metric_dist(int metric, const float* fa,
                                             const float* fc, int64_t d,
                                             float na, float nb) {
  switch (metric) {
    case pald::kSqEuclidean:
      return feat_dist<pald::kSqEuclidean>(fa, fc, d, na, nb);
    case pald::kEuclidean:
      return feat_dist<pald::kEuclidean>(fa, fc, d, na, nb);
    case pald::kCosine:
      return feat_dist<pald::kCosine>(fa, fc, d, na, nb);
    default:
      return feat_dist<pald::kManhattan>(fa, fc, d, na, nb);
  }
}

// source 3: the neighbors' feature rows, X[idx_j] (nbr: X is the (n, k, d)
// block of each row's neighbor rows, row j of x's at (x k + j) d).  Shared
// memory a warp (floats): dn, W, idx, norms (4k), then the tile (kTile:
// k * tile_pitch(k)), then the staged rows (fpitch > 0: k * fpitch; 0:
// read from X).  Row x's global index is row_off + x; item y's X xstride
// elements past the previous item's.
template <bool kTile, class F, bool kChunk>
__global__ void __launch_bounds__(kThreads)
knn_feat_kernel(const float* __restrict__ dn, const float* __restrict__ X,
                int64_t d, int64_t xstride, const int* __restrict__ idx,
                float* __restrict__ out, int64_t n, int k, int metric,
                int fpitch, int wstride, int64_t row_off, bool nbr,
                Params p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.y;
    dn += item * n * k;
    idx += item * n * k;
    out += item * n * (k + 1);
    X += item * xstride;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (x >= n) return;
  float* base = smem + static_cast<int64_t>(warp) * wstride;
  const RowSmem r = load_row(base, dn, idx, x, k, lane);
  const int* si = r.si;
  float* snrm = base + 3 * k;
  float* tile = snrm + k;
  float* sf = tile + (kTile ? k * tile_pitch(k) : 0);
  auto src = [&](int j) -> const float* {
    return X + (nbr ? x * k + j : static_cast<int64_t>(si[j])) * d;
  };
  if (fpitch > 0) {
    const int dd = static_cast<int>(d);  // k d <= kStageBytes / 4 here
    for (int e = lane; e < k * dd; e += 32) {
      const int j = e / dd, f = e - j * dd;
      sf[j * fpitch + f] = src(j)[f];
    }
    __syncwarp();
  }
  auto feats = [&](int j) -> const float* {
    return fpitch > 0 ? sf + j * fpitch : src(j);
  };
  // the neighbors' norms, each a loop over its features in order (the
  // row-norm pre-pass's steps; manhattan has none)
  for (int j = lane; j < k; j += 32) {
    const float* fj = feats(j);
    float s = 0.f;
    if (metric != pald::kManhattan)
      for (int64_t f = 0; f < d; ++f)
        s = Dist<pald::kSqEuclidean>::step(s, fj[f], fj[f]);
    snrm[j] = metric == pald::kCosine ? Dist<pald::kCosine>::norm(s) : s;
  }
  __syncwarp();
  // d(nbr_a, nbr_c): exactly 0 for the same index
  auto dist = [&](int a, int c) {
    if (si[a] == si[c]) return 0.f;
    return metric_dist(metric, feats(a), feats(c), d, snrm[a], snrm[c]);
  };
  if constexpr (kTile) {
    const int tp = tile_pitch(k);
    for (int a = lane; a < k; a += 32) tile[a * tp + a] = 0.f;
    // step f: row f's entries (f, f+1..k-1), then row k-2-f's (k-2-f,
    // k-1-f..k-1); the middle row of an even k twice (the same bits)
    for (int f = 0; f < k / 2; ++f) {
      for (int e = lane; e < k; e += 32) {
        const bool first = e < k - 1 - f;
        const int a = first ? f : k - 2 - f;
        const int c = first ? f + 1 + e : e;
        const float v = dist(a, c);
        tile[a * tp + c] = v;
        tile[c * tp + a] = v;
      }
    }
    __syncwarp();
    values_passes<F>([&](int j, int m) { return tile[j * tp + m]; }, r, x,
                     row_off + x, k, lane, p, out);
  } else {
    values_passes<F>(dist, r, x, row_off + x, k, lane, p, out);
  }
}

// ---------------------------------------------------------------------------
// the large-k variant (k > kLargeK): every warp of a block on one row
// ---------------------------------------------------------------------------
// Row x's state where it lies: dn and idx in place, W in the block's
// scratch
struct BigRow {
  const float* sd;
  float* sw;
  const int* si;
};

// this block's 2 k floats of the scratch: W, then the D source's sorted
// positions past kSweepPermBytes of them
__device__ __forceinline__ float* block_scratch(float* scratch, int k) {
  return scratch +
         (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * k;
}

// The block's rows blockIdx.x, blockIdx.x + gridDim.x, ..., each run by
// body(x) with every warp, a barrier after each (its scratch and staging
// are then free for the next).
template <class Body>
__device__ __forceinline__ void each_big_row(int64_t n, Body&& body) {
  for (int64_t x = blockIdx.x; x < n; x += gridDim.x) {
    body(x);
    __syncthreads();
  }
}

// values_passes by the kBigWarps warps of a block on row x: pass 1 deals
// the pairs j to the warps in turn (each U[j] still one warp's sum over m
// = lane, lane + 32, ..., then warp_sum), warp 0 sums the self column,
// and pass 2 deals the column groups m0 to the warps (each column's
// two-level sum over j in order).  Every value is values_passes's
// expression in its order, so the two give the same bits.
template <class F, class Get>
__device__ __forceinline__ void values_passes_big(const Get& get,
                                                  const BigRow& r,
                                                  int64_t x, int64_t gx,
                                                  int k, int lane, int warp,
                                                  const Params& p,
                                                  float* out) {
  const float* sd = r.sd;
  float* sw = r.sw;
  const int* si = r.si;
  // pass 1: U[j] and W[j] for every pair (x, nbr_j)
  for (int j = warp; j < k; j += kBigWarps) {
    const float dxy = sd[j];
    float part = 0.f;
    for (int m = lane; m < k; m += 32)
      part = __fadd_rn(part, F::focus(sd[m], get(j, m), dxy, p));
    const float u = __fadd_rn(F::focus(0.f, dxy, dxy, p), warp_sum(part));
    if (lane == 0) sw[j] = u > 0.f ? __fdiv_rn(1.f, u) : 0.f;
  }
  __syncthreads();

  float* ox = out + x * static_cast<int64_t>(k + 1);
  if (warp == 0) self_column<F>(sd, si, sw, k, gx, ox, p);

  // pass 2: the neighbor columns z = nbr_m, lane l taking m = m0 + l
  for (int m0 = 32 * warp; m0 < k; m0 += 32 * kBigWarps) {
    const int m = m0 + lane;
    if (m >= k) break;
    const float dxz = sd[m];
    float total = 0.f, acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float t =
          KnnSupport<F>::eval(dxz, get(j, m), sd[j], gx > si[j], p);
      acc = __fadd_rn(acc, __fmul_rn(t, sw[j]));
      if ((j & 31) == 31) {
        total = __fadd_rn(total, acc);
        acc = 0.f;
      }
    }
    ox[1 + m] = __fadd_rn(total, acc);
  }
}

// source 1, large k: the gathered cube g (n, k, k)
template <class F>
__global__ void __launch_bounds__(kBigThreads)
knn_cube_big_kernel(const float* __restrict__ dn,
                    const float* __restrict__ g,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int64_t n, int k, float* scratch, Params p) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* sw = block_scratch(scratch, k);
  each_big_row(n, [&](int64_t x) {
    const float* gx = g + x * static_cast<int64_t>(k) * k;
    values_passes_big<F>(
        [&](int j, int m) { return gx[static_cast<int64_t>(j) * k + m]; },
        BigRow{dn + x * k, sw, idx + x * k}, x, x, k, lane, warp, p, out);
  });
}

// source 2, large k: D (ldd columns), in one sweep of the row's tile.  A
// block of sweep_threads(k) threads on row x (rows blockIdx.x, +
// gridDim.x, ...): the row's k neighbor positions sorted by their index
// (sort_by_index: perm, in shared memory up to kSweepPermBytes, else in
// the scratch beside W), each thread holding kSweepCols sorted columns c
// = i * threads + tid.  Then tiles of kSweepRows rows j in order: each
// thread gathers g(j, c) = D[idx_j, idx_perm[c]] of its columns (a warp
// reads 32 neighbors in ascending column order), sums pass 1's focus
// terms over them, the warps' sums meet in shared memory (in warp order)
// to give U[j] and W[j], and each thread adds pass 2's terms of the
// tile's rows to its columns' two-level sums.  So each entry of the tile
// is read once.  Past threads * kSweepCols columns (k > 4096) pass 1 runs
// first over every piece of columns, then pass 2 a piece at a time (each
// entry read twice).  Item y's D dstride elements past the previous
// item's.
constexpr int kSweepCols = 8;
constexpr int kSweepRows = 4;
constexpr int kSweepThreads = 512;
constexpr int kSweepPermBytes = 64 << 10;
constexpr int kSweepRedBytes = 2 * kSweepRows * (kSweepThreads / 32) * 4;

// the threads of a D-source block at k: whole warps, kSweepCols columns
// each, at most kSweepThreads
__host__ __device__ int sweep_threads(int k) {
  const int t = (k + kSweepCols - 1) / kSweepCols;
  const int w = (t + 31) / 32 * 32;
  return w < kSweepThreads ? w : kSweepThreads;
}

// its dynamic shared memory: the sorted positions while they fit
__host__ __device__ int sweep_smem_bytes(int k) {
  return 4 * k <= kSweepPermBytes ? 4 * k : 0;
}

// perm[0..k) = the positions 0..k-1 sorted by (ix[m], m), by the block: a
// bitonic sort of the next power of two, every compare-exchange putting
// the smaller at the lower position, so the positions past k (+inf) never
// move and are never stored.  Ends with a barrier.
__device__ __forceinline__ void sort_by_index(int* perm,
                                              const int* __restrict__ ix,
                                              int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < k; c += nt) perm[c] = c;
  __syncthreads();
  int k2 = 1;
  while (k2 < k) k2 <<= 1;
  auto exchange = [&](int a, int b) {  // a < b
    if (b >= k) return;
    const int pa = perm[a], pb = perm[b];
    const int ia = __ldg(ix + pa), ib = __ldg(ix + pb);
    if (ib < ia || (ib == ia && pb < pa)) {
      perm[a] = pb;
      perm[b] = pa;
    }
  };
  for (int size = 2; size <= k2; size <<= 1) {
    const int half = size >> 1;
    // each block of `size`: its first half against its second reversed
    for (int t = tid; t < k2 / 2; t += nt) {
      const int base = (t & ~(half - 1)) << 1, o = t & (half - 1);
      exchange(base + o, base + size - 1 - o);
    }
    __syncthreads();
    for (int h = half >> 1; h > 0; h >>= 1) {
      for (int t = tid; t < k2 / 2; t += nt) {
        const int a = ((t & ~(h - 1)) << 1) | (t & (h - 1));
        exchange(a, a + h);
      }
      __syncthreads();
    }
  }
}

template <class F, bool kChunk>
__global__ void __launch_bounds__(kSweepThreads)
knn_dist_sweep_kernel(const float* __restrict__ dn,
                      const float* __restrict__ D, int64_t ldd,
                      int64_t dstride, const int* __restrict__ idx,
                      float* __restrict__ out, int64_t n, int k,
                      float* scratch, Params p) {
  constexpr int C = kSweepCols, TJ = kSweepRows;
  extern __shared__ int sperm[];
  __shared__ float red[2][TJ][kSweepThreads / 32];
  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.y;
    dn += item * n * k;
    idx += item * n * k;
    out += item * n * (k + 1);
    D += item * dstride;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nt = blockDim.x, nw = nt / 32;
  float* sw = block_scratch(scratch, k);
  int* perm = sweep_smem_bytes(k) > 0 ? sperm
                                      : reinterpret_cast<int*>(sw + k);
  const int span = nt * C;  // the columns of a piece
  const int pieces = (k + span - 1) / span;
  int buf = 0;  // red's half for the next tile

  each_big_row(n, [&](int64_t x) {
    const float* dx = dn + x * k;
    const int* ix = idx + x * k;
    sort_by_index(perm, ix, k);
    // this thread's columns of piece pc: their position m (-1: none),
    // column index and dn
    int mz[C], col[C];
    float dz[C];
    auto columns = [&](int pc) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = pc * span + i * nt + tid;
        mz[i] = c < k ? perm[c] : -1;
        col[i] = mz[i] >= 0 ? __ldg(ix + mz[i]) : 0;
        dz[i] = mz[i] >= 0 ? __ldg(dx + mz[i]) : 0.f;
      }
    };
    // g(j0 + r, c) of the thread's columns for the tile's rows
    float g[TJ][C];
    auto gather = [&](int j0) {
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int j = j0 + r;
        const float* row =
            D + static_cast<int64_t>(j < k ? __ldg(ix + j) : 0) * ldd;
#pragma unroll
        for (int i = 0; i < C; ++i)
          g[r][i] = j < k && mz[i] >= 0 ? __ldg(row + col[i]) : 0.f;
      }
    };
    // pass 1's terms of the tile's rows over the thread's columns
    float part[TJ];
    auto partials = [&](int j0) {
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int j = j0 + r;
        if (j >= k) break;
        const float dxy = __ldg(dx + j);
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (mz[i] >= 0)
            part[r] = __fadd_rn(part[r], F::focus(dz[i], g[r][i], dxy, p));
      }
    };
    // W of the tile's rows from the partials: each warp's sum to red, then
    // in every warp lane r adds the warps' sums in warp order; wr[r] the
    // tile's W (warp 0 also writes it to the scratch)
    float wr[TJ];
    auto weights = [&](int j0) {
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == 0) red[buf][r][warp] = s;
      }
      __syncthreads();
      float wv = 0.f;
      const int j = j0 + lane;
      if (lane < TJ && j < k) {
        const float dxy = __ldg(dx + j);
        float s = 0.f;
        for (int w = 0; w < nw; ++w) s = __fadd_rn(s, red[buf][lane][w]);
        const float u = __fadd_rn(F::focus(0.f, dxy, dxy, p), s);
        wv = u > 0.f ? __fdiv_rn(1.f, u) : 0.f;
        if (warp == 0) sw[j] = wv;
      }
#pragma unroll
      for (int r = 0; r < TJ; ++r) wr[r] = __shfl_sync(0xffffffffu, wv, r);
      buf ^= 1;
    };
    // pass 2's terms of the tile's rows, in order, into the columns' sums
    float total[C], acc[C];
    auto accumulate = [&](int j0) {
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int j = j0 + r;
        if (j >= k) break;
        const float dxy = __ldg(dx + j);
        const bool ow = x > __ldg(ix + j);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (mz[i] >= 0) {
            const float t =
                KnnSupport<F>::eval(dz[i], g[r][i], dxy, ow, p);
            acc[i] = __fadd_rn(acc[i], __fmul_rn(t, wr[r]));
          }
        }
        if ((j & 31) == 31) {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            total[i] = __fadd_rn(total[i], acc[i]);
            acc[i] = 0.f;
          }
        }
      }
    };
    float* ox = out + x * static_cast<int64_t>(k + 1);
    auto write = [&]() {
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (mz[i] >= 0) ox[1 + mz[i]] = __fadd_rn(total[i], acc[i]);
    };
    auto zero = [&](float (&v)[C]) {
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = 0.f;
    };
    auto zero_parts = [&]() {
#pragma unroll
      for (int r = 0; r < TJ; ++r) part[r] = 0.f;
    };

    if (pieces == 1) {  // one sweep: each entry read once
      columns(0);
      zero(total);
      zero(acc);
      for (int j0 = 0; j0 < k; j0 += TJ) {
        gather(j0);
        zero_parts();
        partials(j0);
        weights(j0);
        accumulate(j0);
      }
      write();
    } else {  // pass 1 over every piece, then pass 2 a piece at a time
      for (int j0 = 0; j0 < k; j0 += TJ) {
        zero_parts();
        for (int pc = 0; pc < pieces; ++pc) {
          columns(pc);
          gather(j0);
          partials(j0);
        }
        weights(j0);
      }
      __syncthreads();  // every W in the scratch
      for (int pc = 0; pc < pieces; ++pc) {
        columns(pc);
        zero(total);
        zero(acc);
        for (int j0 = 0; j0 < k; j0 += TJ) {
          gather(j0);
#pragma unroll
          for (int r = 0; r < TJ; ++r)
            wr[r] = j0 + r < k ? sw[j0 + r] : 0.f;
          accumulate(j0);
        }
        write();
      }
    }
    __syncthreads();  // every W in the scratch
    if (warp == 0) self_column<F>(dx, ix, sw, k, x, ox, p);
  });
}

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

unsigned row_blocks(int64_t n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

// the row blocks of a grid: four rows a block, or (big) one row a block
// in turn, at most kBigGrid blocks
unsigned grid_rows(int64_t n, bool big) {
  return big ? static_cast<unsigned>(n < kBigGrid ? n : kBigGrid)
             : row_blocks(n);
}

// the shared memory of a block of the cube and D sources: four rows' dn,
// W and idx (none in the cube source's large-k variant)
size_t state_bytes(int k) { return size_t(kWarps) * 3 * k * sizeof(float); }

struct CubeLaunch {
  const float* dn;
  const float* g;
  const int* idx;
  float* out;
  int64_t n;
  int k;
  float* scratch;
  Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    if (scratch != nullptr) {  // the large-k variant
      knn_cube_big_kernel<F><<<grid_rows(n, true), kBigThreads, 0,
                               stream>>>(dn, g, idx, out, n, k, scratch, p);
      return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = state_bytes(k);
    const int st = set_smem(knn_cube_kernel<F>, smem);
    if (st != 0) return st;
    knn_cube_kernel<F><<<row_blocks(n), kThreads, smem, stream>>>(
        dn, g, idx, out, n, k, p);
    return static_cast<int>(cudaGetLastError());
  }
};

// launch(grid, i0) for each group of up to kMaxItems items of a chunk,
// starting at item i0: grid (grid_rows(n, big), the group's items).  The
// groups run in turn on one stream, so a large-k scratch serves them all.
template <class Launch>
int item_grids(int64_t n, int64_t items, bool big, Launch&& launch) {
  for (int64_t i0 = 0; i0 < items; i0 += kMaxItems) {
    const int64_t b = items - i0 < kMaxItems ? items - i0 : kMaxItems;
    launch(dim3(grid_rows(n, big), static_cast<unsigned>(b)), i0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

struct DistLaunch {
  const float* dn;
  const float* D;
  int64_t ldd, dstride;
  const int* idx;
  float* out;
  int64_t n;
  int k;
  int64_t items;
  float* scratch;
  Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    if (scratch != nullptr) {  // the large-k variant: one sweep
      const auto kern = items > 1 ? knn_dist_sweep_kernel<F, true>
                                  : knn_dist_sweep_kernel<F, false>;
      const int smem = sweep_smem_bytes(k);
      if (smem > (48 << 10)) {
        const int st = set_smem(kern, smem);
        if (st != 0) return st;
      }
      return item_grids(n, items, true, [&](dim3 grid, int64_t i0) {
        const int64_t e = i0 * n * k;
        kern<<<grid, sweep_threads(k), smem, stream>>>(
            dn + e, D + i0 * dstride, ldd, dstride, idx + e,
            out + i0 * n * (k + 1), n, k, scratch, p);
      });
    }
    const size_t smem = state_bytes(k);
    const auto kern =
        items > 1 ? knn_dist_kernel<F, true> : knn_dist_kernel<F, false>;
    const int st = set_smem(kern, smem);
    if (st != 0) return st;
    return item_grids(n, items, false, [&](dim3 grid, int64_t i0) {
      const int64_t e = i0 * n * k;
      kern<<<grid, kThreads, smem, stream>>>(
          dn + e, D + i0 * dstride, ldd, dstride, idx + e,
          out + i0 * n * (k + 1), n, k, p);
    });
  }
};

// The features source's floats per warp at (k, d): dn, W, idx, norms,
// the tile for k <= kTileMaxK, and the k staged rows when they fit in
// kStageBytes (*fpitch their pitch, odd so that a column of staged rows
// hits 32 banks; 0: the rows are read from X).
int feat_layout(int k, int64_t d, int* fpitch) {
  const int64_t fp = d | 1;
  *fpitch = d > 0 && k * fp * 4 <= kStageBytes ? static_cast<int>(fp) : 0;
  return 4 * k + (k <= kTileMaxK ? k * tile_pitch(k) : 0) + k * *fpitch;
}

// the features source for family F
struct FeatLaunch {
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
  Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    const bool chunk = items > 1;
    int fpitch;
    const bool tile = k <= kTileMaxK;
    const int wstride = feat_layout(k, d, &fpitch);
    const size_t smem = size_t(kWarps) * wstride * sizeof(float);
    const auto kern = tile ? (chunk ? knn_feat_kernel<true, F, true>
                                    : knn_feat_kernel<true, F, false>)
                           : (chunk ? knn_feat_kernel<false, F, true>
                                    : knn_feat_kernel<false, F, false>);
    const int st = set_smem(kern, smem);
    if (st != 0) return st;
    return item_grids(n, items, false, [&](dim3 grid, int64_t i0) {
      const int64_t e = i0 * n * k;
      kern<<<grid, kThreads, smem, stream>>>(
          dn + e, X + i0 * xstride, d, xstride, idx + e,
          out + i0 * n * (k + 1), n, k, metric, fpitch, wstride, row_off,
          nbr, p);
    });
  }
};

// n, k in range; past kLargeK only with a scratch (the large-k variant)
bool bad_shape(int64_t n, int k, const float* scratch) {
  return n < 1 || k < 1 || (k > kLargeK && scratch == nullptr) ||
         (n + kWarps - 1) / kWarps > static_cast<int64_t>(0x7fffffff);
}

}  // namespace

// The sparse cohesion values out (n, k+1) float32 of the graph (dn (n, k)
// float32, idx (n, k) int32, all row-major contiguous) for weight family
// `wid` with parameters p0, p1, the neighbor-to-neighbor distances taken
// from g (n, k, k) float32.  Needs n >= 1 and k >= 1.  `scratch` non-null
// runs the large-k variant (required past k = 1024): 2 k float32 for each
// block of its grids, min(n, 1024) blocks times the items of a grid
// (min(items, 65535)); null runs four rows a block.  Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for an unknown
// family or a shape out of range).
extern "C" int pald_knn_values_f32(const float* dn, const float* g,
                                   const int* idx, float* out, int64_t n,
                                   int k, float* scratch, int wid, float p0,
                                   float p1, void* stream) {
  if (bad_shape(n, k, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(
      wid, CubeLaunch{dn, g, idx, out, n, k, scratch, {p0, p1},
                      static_cast<cudaStream_t>(stream)});
}

// The same with the distances computed from the neighbors' rows of X (m,
// d) float32 for `metric` (0 sqeuclidean, 1 euclidean, 2 cosine, 3
// manhattan), bitwise gather_tile_from_features's; with nbr != 0, X is
// the (n, k, d) block of each row's neighbor rows instead.  Row x of the
// graph has global index row_off + x (>= 0).  A chunk of `items` graphs
// (dn, idx (items, n, k), out (items, n, k+1)) reads item i's X at X + i
// xstride, its indices within it; one grid per 65535 items.  `scratch`
// must be null: past k = 1024 the features source is the register tiles'
// entry (pald_knn_large.cu up to 16 features, pald_knn_wide.cu up to 64,
// pald_knn_piece.cu past).
extern "C" int pald_knn_values_features_f32(const float* dn, const float* X,
                                            int64_t d, const int* idx,
                                            float* out, int64_t n, int k,
                                            int metric, int64_t row_off,
                                            int nbr, int64_t items,
                                            int64_t xstride, float* scratch,
                                            int wid, float p0, float p1,
                                            void* stream) {
  if (bad_shape(n, k, scratch) || d < 0 || row_off < 0 || items < 1 ||
      xstride < 0 || metric < pald::kSqEuclidean ||
      metric > pald::kManhattan || scratch != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(
      wid, FeatLaunch{dn, X, d, xstride, idx, out, n, k, metric, row_off,
                      nbr != 0, items, {p0, p1},
                      static_cast<cudaStream_t>(stream)});
}

// The same with the distances read from D (rows of ldd float32),
// D[idx_j, idx_m] as gather_tile_from_distances gathers them; a chunk of
// `items` graphs reads item i's D at D + i dstride.  `scratch` as
// pald_knn_values_f32's (past k = 1024 the one sweep, a block of
// sweep_threads(k) threads).
extern "C" int pald_knn_values_distances_f32(const float* dn, const float* D,
                                             int64_t ldd, const int* idx,
                                             float* out, int64_t n, int k,
                                             int64_t items, int64_t dstride,
                                             float* scratch, int wid,
                                             float p0, float p1,
                                             void* stream) {
  if (bad_shape(n, k, scratch) || ldd < 1 || items < 1 || dstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(
      wid, DistLaunch{dn, D, ldd, dstride, idx, out, n, k, items, scratch,
                      {p0, p1}, static_cast<cudaStream_t>(stream)});
}

// The shared memory of a values block at k, in bytes, as the launches set
// it: the features source's at width d (past kLargeK the register tiles',
// pald_knn_reg.cuh), for d < 0 the cube and D sources' (past kLargeK the D
// source's one sweep: its reduction buffer and, while they fit, the
// sorted positions; the cube source's large-k variant holds none); -1 for
// k < 1.
extern "C" int pald_knn_smem_bytes(int k, int64_t d) {
  if (k < 1) return -1;
  const bool big = k > kLargeK;
  if (d < 0)
    return big ? kSweepRedBytes + sweep_smem_bytes(k)
               : static_cast<int>(state_bytes(k));
  if (big) return pald::knn::reg_smem_bytes(d);
  int fpitch;
  return static_cast<int>(kWarps * feat_layout(k, d, &fpitch) *
                          sizeof(float));
}
