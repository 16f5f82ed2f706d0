// PaLD's two passes on Hopper straight from feature vectors
//
//     U[x, y] = sum_z focus(d(x, z), d(y, z), d(x, y))
//     C[x, z] = sum_y support(d(x, z), d(y, z), d(x, y), x > y) * W[x, y]
//
// with d(a, b) computed from the rows of X (n, d) inside the kernels, so
// the (n, n) distance matrix never exists in device memory.  Replaces the
// TPU kernels repro/kernels/pald_fused.py::focus_fused_pallas and
// cohesion_fused_pallas.
//
// What bounds it on the H100: operations.  The triple loops are those of
// the dense kernels (3 and 4 FP32 lane instructions per (x, y, z) triple;
// pald_tile.cuh).  On top, every 32-wide slab of the reduced axis needs its
// 2 x 64 x 32 distances, each a d-long sum of a rounded multiply and a
// rounded add (no FMA: pald_dist.cuh), recomputed for every output tile:
// d/16 lane instructions per triple, 4 at d = 64.  The data are X (n d
// floats), W and the output: at n = 8192, d = 64 about 0.5 GB of memory
// traffic against ~1.2e12 lane instructions.
//
// Design.  The thread blocks, tiles and inner loops are the dense kernels':
// a block owns a 64 x 64 output tile and its 256 threads a 4 x 4 block of
// outputs each, with their fixed operand (focus: d(x, y); cohesion:
// d(x, z)) in registers, computed once per tile.  The one change is the
// staging: where a dense kernel loads a slab of distances from global
// memory, these compute it from feature rows into the same shared layout.
// The feature axis is streamed in chunks of 16 (the 64 + 64 + 32 rows a
// slab needs, transposed to [k][row]), so any d >= 1 fits in the 48 KB of
// static shared memory; a thread accumulates 2 x 4 + 2 x 4 pair sums in
// registers, reading 4 + 4 + 2 features per k from shared memory for 16
// multiply-adds, while its share of the next chunk is loaded from global
// memory into registers.  The rows' norms come from a pre-pass into an (n,)
// scratch buffer that the wrapper allocates (one thread per row).
//
// Bitwise contract: every distance is computed by pald_dist.cuh, the same
// operations in the same order as repro_torch.core.features, so on the
// same X the kernels see bitwise the distances of cdist_reference(X), and
// the fused U equals the dense kernel's U on that matrix.
//
// Padding and ragged edges: rows at index >= n_valid are +inf from
// everything, and the global diagonal is exactly 0 (masked_dist_tile's
// contract).  Rows past n are never read; the last slab loops to its own
// length, and outputs past n are never stored, so the caller pads nothing.
// The index tiebreak of `ignore` is the global "x > y", as in the TPU
// kernel's grid: a slab off the diagonal runs with it as a compile-time
// constant.  64-bit offsets (n^2 overflows int32 above n = 46340).
#include "pald_dist.cuh"
#include "pald_tile.cuh"

namespace {

using pald::Dist;
using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

constexpr int kChunk = 16;          // features staged per step
constexpr int kLdS = kSlab + 4;     // padded row of the staged slab rows
// two blocks per SM: caps the passes at 128 registers a thread (without
// it ptxas gave the cohesion kernels up to 255, one block per SM)
constexpr int kMinBlocks = 2;

// One thread's share of a chunk of feature rows: rows [r0, r0 + Rows) x
// features [k0, k0 + kChunk) of X, read into registers (rows past n and
// features past d read as 0; neighbouring threads read neighbouring
// features of one row) and stored transposed into f[k][r].  Loading the
// next chunk into registers while the current one is in use keeps the
// global loads in flight under the arithmetic.
template <int Rows>
struct RowChunk {
  static constexpr int kPer = Rows * kChunk / kThreads;
  static_assert(kPer * kThreads == Rows * kChunk, "whole chunks per thread");
  float v[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       int64_t r0, int64_t n, int64_t d,
                                       int64_t k0, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int64_t row = r0 + e / kChunk, k = k0 + e % kChunk;
      v[i] = (row < n && k < d) ? x[row * d + k] : 0.f;
    }
  }

  template <int Ld>
  __device__ __forceinline__ void store(float (*f)[Ld], int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      f[e % kChunk][e / kChunk] = v[i];
    }
  }
};

__device__ __forceinline__ float norm_of(const float* __restrict__ norms,
                                         int64_t row, int64_t n) {
  return row < n ? norms[row] : 0.f;
}

struct Stage {
  float fa[kChunk][kLd];    // features of the tile's A rows (x)
  float fb[kChunk][kLd];    // features of the tile's B rows (focus: y,
                            // cohesion: z)
  float fs[kChunk][kLdS];   // features of the slab's rows
};

// Run step(k) for every feature k of a staged chunk, in order; a full
// chunk unrolled
template <class Step>
__device__ __forceinline__ void chunk_steps(int kc, Step&& step) {
  if (kc == kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) step(k);
  } else {
    for (int k = 0; k < kc; ++k) step(k);
  }
}

// d(A[ty*4 + i], B[tx*4 + j]) of the 64 x 64 tile into out[i][j]
template <int M>
__device__ __forceinline__ void tile_dists(
    Stage& s, const float* __restrict__ x, const float* __restrict__ norms,
    int64_t a0, int64_t b0, int64_t n, int64_t d, int64_t n_valid, int tid,
    int tx, int ty, float (&out)[4][4]) {
  float acc[4][4] = {};
  RowChunk<kTile> ca, cb;
  ca.load(x, a0, n, d, 0, tid);
  cb.load(x, b0, n, d, 0, tid);
  for (int64_t k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = static_cast<int>(d - k0 < kChunk ? d - k0 : kChunk);
    ca.store(s.fa, tid);
    cb.store(s.fb, tid);
    __syncthreads();
    if (k0 + kChunk < d) {  // the next chunk, in flight under the sums
      ca.load(x, a0, n, d, k0 + kChunk, tid);
      cb.load(x, b0, n, d, k0 + kChunk, tid);
    }
    chunk_steps(kc, [&](int k) {
      const float4 a = *reinterpret_cast<const float4*>(&s.fa[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.fb[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = Dist<M>::step(acc[i][j], av[i], bv[j]);
    });
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t a = a0 + ty * 4 + i, b = b0 + tx * 4 + j;
      float na = 0.f, nb = 0.f;
      if constexpr (Dist<M>::kNorms) {
        na = norm_of(norms, a, n);
        nb = norm_of(norms, b, n);
      }
      out[i][j] = pald::masked(Dist<M>::finish(acc[i][j], na, nb), a, b,
                               n_valid);
    }
}

// The slab's distances: sa[r][a] = d(S[r], A[a]) and sb[r][b] =
// d(S[r], B[b]) for the 32 slab rows S = s0.. and the tile's 64 A and
// 64 B rows.  Thread (g, h) = (tid % 16, tid / 16) computes A and B rows
// 4g..4g+3 against slab rows 2h, 2h+1.
template <int M>
__device__ __forceinline__ void slab_dists(
    Stage& s, const float* __restrict__ x, const float* __restrict__ norms,
    int64_t a0, int64_t b0, int64_t s0, int64_t n, int64_t d,
    int64_t n_valid, int tid, float (*sa)[kLd], float (*sb)[kLd]) {
  const int g = tid % 16, h = tid / 16;
  float acc_a[2][4] = {}, acc_b[2][4] = {};
  RowChunk<kTile> ca, cb;
  RowChunk<kSlab> cs;
  ca.load(x, a0, n, d, 0, tid);
  cb.load(x, b0, n, d, 0, tid);
  cs.load(x, s0, n, d, 0, tid);
  for (int64_t k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = static_cast<int>(d - k0 < kChunk ? d - k0 : kChunk);
    ca.store(s.fa, tid);
    cb.store(s.fb, tid);
    cs.store(s.fs, tid);
    __syncthreads();
    if (k0 + kChunk < d) {  // the next chunk, in flight under the sums
      ca.load(x, a0, n, d, k0 + kChunk, tid);
      cb.load(x, b0, n, d, k0 + kChunk, tid);
      cs.load(x, s0, n, d, k0 + kChunk, tid);
    }
    chunk_steps(kc, [&](int k) {
      const float4 a = *reinterpret_cast<const float4*>(&s.fa[k][g * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.fb[k][g * 4]);
      const float2 r = *reinterpret_cast<const float2*>(&s.fs[k][h * 2]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float rv[2] = {r.x, r.y};
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[u][j] = Dist<M>::step(acc_a[u][j], rv[u], av[j]);
          acc_b[u][j] = Dist<M>::step(acc_b[u][j], rv[u], bv[j]);
        }
    });
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int64_t row = s0 + h * 2 + u;
    const float nr = Dist<M>::kNorms ? norm_of(norms, row, n) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t a = a0 + g * 4 + j, b = b0 + g * 4 + j;
      float na = 0.f, nb = 0.f;
      if constexpr (Dist<M>::kNorms) {
        na = norm_of(norms, a, n);
        nb = norm_of(norms, b, n);
      }
      sa[h * 2 + u][g * 4 + j] =
          pald::masked(Dist<M>::finish(acc_a[u][j], nr, na), row, a, n_valid);
      sb[h * 2 + u][g * 4 + j] =
          pald::masked(Dist<M>::finish(acc_b[u][j], nr, nb), row, b, n_valid);
    }
  }
}

template <int M, class F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
focus_fused_kernel(const float* __restrict__ x,
                   const float* __restrict__ norms, float* __restrict__ u,
                   int64_t n, int64_t d, int64_t n_valid, pald::Params p) {
  __shared__ __align__(16) Stage st;
  __shared__ __align__(16) float sx[kSlab][kLd];
  __shared__ __align__(16) float sy[kSlab][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t y0 = static_cast<int64_t>(blockIdx.x) * kTile;

  float thr[4][4], acc[4][4] = {};
  tile_dists<M>(st, x, norms, x0, y0, n, d, n_valid, tid, tx, ty, thr);
  for (int64_t z0 = 0; z0 < n; z0 += kSlab) {
    const int zn = static_cast<int>(n - z0 < kSlab ? n - z0 : kSlab);
    slab_dists<M>(st, x, norms, x0, y0, z0, n, d, n_valid, tid, sx, sy);
    __syncthreads();
    pald::focus_slab<F>(sx, sy, zn, tx, ty, thr, acc, p);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t xi = x0 + ty * 4 + i, yj = y0 + tx * 4 + j;
      if (xi < n && yj < n) u[xi * n + yj] = acc[i][j];
    }
}

template <int M, class F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cohesion_fused_kernel(const float* __restrict__ x,
                      const float* __restrict__ norms,
                      const float* __restrict__ w, float* __restrict__ c,
                      int64_t n, int64_t d, int64_t n_valid, pald::Params p) {
  __shared__ __align__(16) Stage st;
  __shared__ __align__(16) float syz[kSlab][kLd];
  __shared__ __align__(16) float sxy[kSlab][kLd];
  __shared__ __align__(16) float sw[kSlab][kLd];
  __shared__ __align__(16) uint8_t sxw[F::kTiebreak ? kSlab : 1][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t x_last = (x0 + kTile < n ? x0 + kTile : n) - 1;

  float own[4][4], acc[4][4] = {};
  tile_dists<M>(st, x, norms, x0, z0, n, d, n_valid, tid, tx, ty, own);
  for (int64_t y0 = 0; y0 < n; y0 += kSlab) {
    const int yn = static_cast<int>(n - y0 < kSlab ? n - y0 : kSlab);
    // d(y, z) into syz[y][z], d(y, x) = d(x, y) into sxy[y][x]
    slab_dists<M>(st, x, norms, x0, z0, y0, n, d, n_valid, tid, sxy, syz);
    // W[x0:x0+64, y0:y0+yn] transposed to [y][x] (a warp reads 32
    // consecutive y of one row)
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, col = e % kSlab;
      const int64_t xi = x0 + r, yi = y0 + col;
      sw[col][r] = (xi < n && col < yn) ? w[xi * n + yi] : 0.f;
    }
    // the global x > y tiebreak over the slab's in-range pairs: all win
    // when the tile's first x is past the slab's last y, some when its
    // last x is past the slab's first y
    const bool all = x0 > y0 + yn - 1, any = x_last > y0;
    if constexpr (F::kTiebreak) {
      if (!all && any) {
        for (int e = tid; e < kTile * kSlab; e += kThreads) {
          const int r = e / kSlab, col = e % kSlab;
          sxw[col][r] = x0 + r > y0 + col;
        }
      }
    }
    __syncthreads();
    pald::cohesion_slab<F>(syz, sxy, sw, sxw, yn, all, any, tx, ty, own, acc,
                           p);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t xi = x0 + ty * 4 + i, zj = z0 + tx * 4 + j;
      if (xi < n && zj < n) c[xi * n + zj] = acc[i][j];
    }
}

// the fused distances written out: D[a, b] for one 64 x 64 tile per block
// (the probe of the bitwise contract; the passes never call it)
template <int M>
__global__ void __launch_bounds__(kThreads)
dist_fused_kernel(const float* __restrict__ x,
                  const float* __restrict__ norms, float* __restrict__ out,
                  int64_t n, int64_t d, int64_t n_valid) {
  __shared__ __align__(16) Stage st;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t a0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTile;
  float dist[4][4];
  tile_dists<M>(st, x, norms, a0, b0, n, d, n_valid, tid, tx, ty, dist);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t a = a0 + ty * 4 + i, b = b0 + tx * 4 + j;
      if (a < n && b < n) out[a * n + b] = dist[i][j];
    }
}

struct Args {
  const float* x;
  float* norms;
  const float* w;   // cohesion only
  float* out;
  int64_t n, d, n_valid;
  pald::Params p;
  cudaStream_t stream;

  dim3 grid() const {
    const unsigned t = static_cast<unsigned>((n + kTile - 1) / kTile);
    return dim3(t, t);
  }
};

template <int M>
int launch_norms(const Args& a) {
  return pald::launch_row_norms<M>(a.x, a.norms, a.n, a.d, a.stream);
}

template <int M>
struct FocusLaunch {
  const Args& a;
  template <class F>
  int operator()() const {
    focus_fused_kernel<M, F><<<a.grid(), kThreads, 0, a.stream>>>(
        a.x, a.norms, a.out, a.n, a.d, a.n_valid, a.p);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int M>
struct CohesionLaunch {
  const Args& a;
  template <class F>
  int operator()() const {
    cohesion_fused_kernel<M, F><<<a.grid(), kThreads, 0, a.stream>>>(
        a.x, a.norms, a.w, a.out, a.n, a.d, a.n_valid, a.p);
    return static_cast<int>(cudaGetLastError());
  }
};

// Pass = FocusLaunch or CohesionLaunch; Pass == void: the distance probe
template <template <int> class Pass>
struct PerMetric {
  const Args& a;
  int wid;
  template <int M>
  int operator()() const {
    const int status = launch_norms<M>(a);
    if (status != 0) return status;
    return pald::dispatch_weight(wid, Pass<M>{a});
  }
};

struct DistPerMetric {
  const Args& a;
  template <int M>
  int operator()() const {
    const int status = launch_norms<M>(a);
    if (status != 0) return status;
    dist_fused_kernel<M><<<a.grid(), kThreads, 0, a.stream>>>(
        a.x, a.norms, a.out, a.n, a.d, a.n_valid);
    return static_cast<int>(cudaGetLastError());
  }
};

bool bad_shape(int64_t n, int64_t d, int64_t n_valid) {
  return n < 1 || d < 0 || n_valid < 0 || n_valid > n ||
         (n + kTile - 1) / kTile > 65535;
}

}  // namespace

// U (n, n) from row-major contiguous float32 X (n, d), for `metric` (0
// sqeuclidean, 1 euclidean, 2 cosine, 3 manhattan) and weight family `wid`
// with parameters p0, p1; rows at index >= n_valid are padding.  `norms`
// is an (n,) float32 scratch buffer.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown metric or
// family, or a shape out of range).
extern "C" int pald_focus_fused_f32(const float* x, float* norms, float* u,
                                    int64_t n, int64_t d, int64_t n_valid,
                                    int metric, int wid, float p0, float p1,
                                    void* stream) {
  if (bad_shape(n, d, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, nullptr, u, n, d, n_valid, {p0, p1},
               static_cast<cudaStream_t>(stream)};
  return pald::dispatch_metric(metric, PerMetric<FocusLaunch>{a, wid});
}

// C (n, n) from X (n, d) and the weights W = 1/U (n, n); as above.  The
// index tiebreak of `ignore` is the global x > y.
extern "C" int pald_cohesion_fused_f32(const float* x, float* norms,
                                       const float* w, float* c, int64_t n,
                                       int64_t d, int64_t n_valid, int metric,
                                       int wid, float p0, float p1,
                                       void* stream) {
  if (bad_shape(n, d, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, w, c, n, d, n_valid, {p0, p1},
               static_cast<cudaStream_t>(stream)};
  return pald::dispatch_metric(metric, PerMetric<CohesionLaunch>{a, wid});
}

// D (n, n): the fused kernels' masked distances, written out.
extern "C" int pald_dist_fused_f32(const float* x, float* norms, float* out,
                                   int64_t n, int64_t d, int64_t n_valid,
                                   int metric, void* stream) {
  if (bad_shape(n, d, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, nullptr, out, n, d, n_valid, {0.f, 0.f},
               static_cast<cudaStream_t>(stream)};
  return pald::dispatch_metric(metric, DistPerMetric{a});
}
