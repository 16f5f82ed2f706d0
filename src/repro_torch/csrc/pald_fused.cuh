// PaLD's two passes on Hopper straight from feature vectors, behind the
// entry points of pald_fused.cu (one item, and the distance probe) and
// pald_fused_chunk.cu (a chunk of items):
//
//     U[x, y] = sum_z focus(d(x, z), d(y, z), d(x, y))
//     C[x, z] = sum_y support(d(x, z), d(y, z), d(x, y), x > y) * W[x, y]
//
// with d(a, b) computed from the rows of X (n, d) on the card, one panel of
// rows at a time, so the (n, n) distance matrix is never whole in device
// memory past the panel budget (kernels/pald_fused.py::panel_rows).
// Replaces the TPU kernels repro/kernels/pald_fused.py::focus_fused_pallas
// and cohesion_fused_pallas.
//
// What bounds it on the H100: operations.  The triple loops are those of
// the dense kernels (3 lane instructions per (x, y, z) triple for the
// strict families on a finite W; pald_tile.cuh).  The function needs each
// distance once: 2d + 4 lane instructions per unordered pair, 4.4e9 at
// n = 8192, d = 64, against the loops' ~1.2e12.  The data are X (n d
// floats), W and the output.
//
// Design: a panel of D, written once, read by every output tile.
// The reduced axis (z for focus, y for cohesion) is cut into panels of P
// rows, P a multiple of 64.  For each panel p0 = 0, P, 2P, ... the host
// issues two grids on the stream:
//   1. the panel writer, dist_fused_kernel: Dp[r, c] = d(p0 + r, c) for
//      r < P, c < ldp (n rounded up to 64; columns past n are +inf), into
//      a (P, ldp) float32 scratch buffer that the wrapper allocates once
//      per call (P ldp 4 bytes within a fixed budget).  The pass reads it
//      from L2 a band of slabs at a time: its resident blocks move through
//      the panel's slabs together, so the panel need not fit the 50 MB L2
//      whole.
//   2. the pass over all (n/64)^2 output tiles and the panel's 32-row
//      slabs, with the loops of pald_tile.cuh unchanged.  A block owns a
//      64 x 64 output tile; its fixed operand (focus: d(x, y), cohesion:
//      d(x, z)) comes from tile_dists, once per (tile, panel), and its
//      accumulator is loaded from the output (0 on the first panel) and
//      stored back after the panel's last slab.  The slab layouts are the
//      panel's own: focus sx[z][x] = Dp[z - p0][x], sy[z][y] likewise;
//      cohesion syz[y][z], sxy[y][x] (d(y, x) = d(x, y) bitwise).  Staging
//      is a straight 2-D copy of 16-byte cp.async pieces; the W slab is a
//      transposed read in 4-byte cp.async pieces.  Cohesion's sxy and W
//      rows are swizzled as the dense kernel's (pald_tile.cuh).  Focus stages
//      into two slab buffers, so slab s + 1 arrives while slab s runs;
//      cohesion into one (copy, wait, run): on an H100 a second buffer
//      made focus faster and cohesion, whose shared memory it takes to
//      63 KB, slower (PERF.md).  The output's
//      read-modify-write is cache-streaming, so it does not evict the
//      panel.
// Every distance is computed once per panel; only the fixed operand is
// recomputed, n / P times.  The rows' norms come from a pre-pass into an
// (n,) scratch buffer (one thread per row).
//
// Bitwise contract: every distance is computed by pald_dist.cuh, the same
// operations in the same order as repro_torch.core.features, so on the
// same X the kernels see bitwise the distances of cdist_reference(X); and
// d(a, b) is bitwise d(b, a) (the multiply, |a - b|, na + nb and na * nb
// all commute), so a panel row serves as a column.  P is a multiple of 64:
// the slab boundaries, and with them the order of every float addition,
// do not depend on P, and the accumulator passes through global memory as
// float32.  So U and C are bitwise the same for every P, and U equals the
// dense kernel's U on cdist_reference(X).
//
// Padding and ragged edges: rows at index >= n_valid are +inf from
// everything, and the global diagonal is exactly 0 (masked_dist_tile's
// contract).  Rows past n are never read; the last slab loops to its own
// length, and outputs past n are never stored, so the caller pads nothing.
// The index tiebreak of `ignore` is the global "x > y", as in the TPU
// kernel's grid: a slab off the diagonal runs with it as a compile-time
// constant.  64-bit offsets (n^2 overflows int32 above n = 46340).
//
// A chunk of items (the engine's batch= chunks, the reference's vmap): X
// (b, n, d), W (b, n, n) and the output (b, n, n), one item after another,
// every item of the same shape.  blockIdx.z is the item: the panel writer
// and both passes advance X, the norms, W, the output and the panel by one
// item's extent (n d, n, n^2, n^2 and P ldp elements), so each item's
// blocks run exactly what a one-item grid's do and a chunk's U and C are
// bitwise its items' one at a time.  The kernels take the item only in
// their kItems variants, which pald_fused_chunk.cu alone instantiates: the
// offsets cost registers, and the passes sit at their 128-register cap, so
// one item runs code without them (and nvcc builds the two halves in
// parallel).  The norms pre-pass runs once over the
// chunk's b n rows (X (b, n, d) contiguous is (b n, d) rows); the panel
// holds one (P, ldp) slab per item of a grid, so the wrapper picks P for
// the chunk (kernels/pald_fused.py::panel_rows).  A grid holds up to 65535
// items (gridDim.z); past that the host issues the panels of each group
// of 65535 in turn, into the same panel buffer.
#pragma once

#include "pald_dist.cuh"
#include "pald_tile.cuh"

namespace pald::fused {

using pald::cp_async16;
using pald::cp_async4;
using pald::cp_async_commit;
using pald::cp_async_wait;
using pald::Dist;
using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

// slab buffers of each pass: 2 overlaps a slab's copies with the previous
// slab's loops; 1 copies, waits, then runs
constexpr int kFocusStages = 2;
constexpr int kCohesionStages = 1;
constexpr int kChunk = 16;          // features staged per step
// two blocks per SM: caps the passes at 128 registers a thread (without
// it ptxas gave the cohesion kernels up to 255, one block per SM)
constexpr int kMinBlocks = 2;
constexpr int64_t kMaxItems = 65535;  // items of one grid (gridDim.z)

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
  float fa[kChunk][kLd];    // features of the tile's A rows
  float fb[kChunk][kLd];    // features of the tile's B rows
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

// panel rows [r0, r0 + rn) (rn <= kSlab), columns [c0, c0 + 64), into
// s[r][0:64] (kSwz: into swizzled rows, pald_tile.cuh swz): 16 consecutive
// 16-byte pieces a row (ldp and c0 are multiples of 64 floats, so every
// piece is aligned)
template <bool kSwz, int Ld>
__device__ __forceinline__ void stage_rows(float (*s)[Ld],
                                           const float* __restrict__ panel,
                                           int64_t ldp, int64_t r0, int rn,
                                           int64_t c0, int tid) {
  constexpr int kPieces = kTile / 4;
  for (int e = tid; e < kSlab * kPieces; e += kThreads) {
    const int r = e / kPieces, q = e % kPieces;
    if (r < rn)
      cp_async16(&s[r][(kSwz ? q ^ pald::swz(r) : q) * 4],
                 panel + (r0 + r) * ldp + c0 + q * 4);
  }
}

// the tile's accumulator: carried in from the output (earlier panels) or 0
__device__ __forceinline__ void load_acc(const float* __restrict__ out,
                                         int64_t n, int64_t r0, int64_t c0,
                                         int tx, int ty, bool carry,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + ty * 4 + i, c = c0 + tx * 4 + j;
      acc[i][j] = (carry && r < n && c < n) ? __ldcs(out + r * n + c) : 0.f;
    }
}

__device__ __forceinline__ void store_acc(float* __restrict__ out, int64_t n,
                                          int64_t r0, int64_t c0, int tx,
                                          int ty, const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (r < n && c < n) __stcs(out + r * n + c, acc[i][j]);
    }
}

// the passes' shared memory, passed as dynamic shared memory (focus
// 43,520 B, cohesion 36,992 B: kernels/pald_fused.py SMEM_PER_CTA)
struct FocusSmem {
  Stage st;
  float sx[kFocusStages][kSlab][kLd];
  float sy[kFocusStages][kSlab][kLd];
};

struct CohesionSmem {
  Stage st;
  float syz[kCohesionStages][kSlab][kLd];
  float sxy[kCohesionStages][kSlab][kTile];  // swizzled rows
  float sw[kCohesionStages][kSlab][kTile];
  uint8_t sxw[kSlab][kLd];
};

// The slab loop of one panel [p0, p_end) over Stages slab buffers:
// stage(r0, buf) issues the copies of the slab starting at r0 into buffer
// buf; run(r0, rn, buf) consumes it.  With two buffers the first slab's
// copies are issued and committed before the loop.
template <int Stages, class StageFn, class RunFn>
__device__ __forceinline__ void panel_slabs(int64_t p0, int64_t p_end,
                                            StageFn&& stage, RunFn&& run) {
  int buf = 0;
  for (int64_t r0 = p0; r0 < p_end; r0 += kSlab) {
    const int rn = static_cast<int>(p_end - r0 < kSlab ? p_end - r0 : kSlab);
    if constexpr (Stages == 2) {
      // slab r0 was issued a step earlier (or before the loop)
      if (r0 + kSlab < p_end) stage(r0 + kSlab, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      stage(r0, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    run(r0, rn, buf);
    __syncthreads();  // the buffer is free for the copies of the next step
    if constexpr (Stages == 2) buf ^= 1;
  }
}

template <int M, class F, bool kItems>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
focus_fused_kernel(const float* __restrict__ x,
                   const float* __restrict__ norms,
                   const float* __restrict__ panel, float* __restrict__ u,
                   int64_t n, int64_t d, int64_t n_valid, int64_t ldp,
                   int64_t pitem, int64_t p0, int64_t pn, pald::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  FocusSmem& sm = *reinterpret_cast<FocusSmem*>(smem);
  if constexpr (kItems) {  // this block's item of the chunk
    const int64_t item = blockIdx.z;
    x += item * n * d;
    norms += item * n;
    panel += item * pitem;
    u += item * n * n;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t y0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t p_end = p0 + pn;

  auto stage = [&](int64_t z0, int buf) {
    const int zn = static_cast<int>(p_end - z0 < kSlab ? p_end - z0 : kSlab);
    stage_rows<false>(sm.sx[buf], panel, ldp, z0 - p0, zn, x0, tid);
    stage_rows<false>(sm.sy[buf], panel, ldp, z0 - p0, zn, y0, tid);
  };
  stage(p0, 0);  // the first slab, in flight under tile_dists
  cp_async_commit();
  float thr[4][4], acc[4][4];
  tile_dists<M>(sm.st, x, norms, x0, y0, n, d, n_valid, tid, tx, ty, thr);
  load_acc(u, n, x0, y0, tx, ty, p0 > 0, acc);
  panel_slabs<kFocusStages>(p0, p_end, stage, [&](int64_t, int zn, int buf) {
    __syncthreads();
    pald::focus_slab<F>(sm.sx[buf], sm.sy[buf], zn, tx, ty, thr, acc, p);
  });
  store_acc(u, n, x0, y0, tx, ty, acc);
}

template <int M, class F, bool kAdd, bool kItems>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cohesion_fused_kernel(const float* __restrict__ x,
                      const float* __restrict__ norms,
                      const float* __restrict__ panel,
                      const float* __restrict__ w, float* __restrict__ c,
                      int64_t n, int64_t d, int64_t n_valid, int64_t ldp,
                      int64_t pitem, int64_t p0, int64_t pn, pald::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  CohesionSmem& sm = *reinterpret_cast<CohesionSmem*>(smem);
  if constexpr (kItems) {  // this block's item of the chunk
    const int64_t item = blockIdx.z;
    x += item * n * d;
    norms += item * n;
    panel += item * pitem;
    w += item * n * n;
    c += item * n * n;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t x_last = (x0 + kTile < n ? x0 + kTile : n) - 1;
  const int64_t p_end = p0 + pn;

  auto stage = [&](int64_t y0, int buf) {
    const int yn = static_cast<int>(p_end - y0 < kSlab ? p_end - y0 : kSlab);
    // d(y, z) into syz[y][z], d(y, x) = d(x, y) into sxy[y][x]
    stage_rows<false>(sm.syz[buf], panel, ldp, y0 - p0, yn, z0, tid);
    stage_rows<true>(sm.sxy[buf], panel, ldp, y0 - p0, yn, x0, tid);
    // W[x0:x0+64, y0:y0+yn] transposed to [y][x] (a warp reads 32
    // consecutive y of one row); rows past n are 0
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, col = e % kSlab;
      const int64_t xi = x0 + r;
      if (col >= yn) continue;
      if (xi < n)
        cp_async4(&sm.sw[buf][col][pald::swizzled(col, r)],
                  w + xi * n + y0 + col);
      else
        sm.sw[buf][col][pald::swizzled(col, r)] = 0.f;
    }
  };
  float own[4][4], acc[4][4];
  tile_dists<M>(sm.st, x, norms, x0, z0, n, d, n_valid, tid, tx, ty, own);
  load_acc(c, n, x0, z0, tx, ty, p0 > 0, acc);
  panel_slabs<kCohesionStages>(p0, p_end, stage,
                               [&](int64_t y0, int yn, int buf) {
    // the global x > y tiebreak over the slab's in-range pairs: all win
    // when the tile's first x is past the slab's last y, some when its
    // last x is past the slab's first y
    const bool all = x0 > y0 + yn - 1, any = x_last > y0;
    if constexpr (F::kTiebreak) {
      if (!all && any) {
        for (int e = tid; e < kTile * kSlab; e += kThreads) {
          const int r = e / kSlab, col = e % kSlab;
          sm.sxw[col][r] = x0 + r > y0 + col;
        }
      }
    }
    __syncthreads();
    pald::cohesion_slab<F, kAdd>(sm.syz[buf], sm.sxy[buf], sm.sw[buf],
                                 sm.sxw, yn, all, any, tx, ty, own, acc, p);
  });
  store_acc(c, n, x0, z0, tx, ty, acc);
}

// The fused distances written out: out[a - row0, b] = D[a, b] for rows
// [row0, row0 + rows) and columns [0, cols), one 64 x 64 tile per block,
// item blockIdx.z's out `oitem` elements past the previous item's.  The
// passes' panel writer, and (rows = cols = ld = n, one item) the probe of
// the bitwise contract.
template <int M, bool kItems>
__global__ void __launch_bounds__(kThreads)
dist_fused_kernel(const float* __restrict__ x,
                  const float* __restrict__ norms, float* __restrict__ out,
                  int64_t ld, int64_t oitem, int64_t row0, int64_t rows,
                  int64_t cols, int64_t n, int64_t d, int64_t n_valid) {
  __shared__ __align__(16) Stage st;
  if constexpr (kItems) {  // this block's item of the chunk
    const int64_t item = blockIdx.z;
    x += item * n * d;
    norms += item * n;
    out += item * oitem;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t a0 = row0 + static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTile;
  float dist[4][4];
  tile_dists<M>(st, x, norms, a0, b0, n, d, n_valid, tid, tx, ty, dist);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t a = a0 + ty * 4 + i - row0, b = b0 + tx * 4 + j;
      if (a < rows && b < cols) out[a * ld + b] = dist[i][j];
    }
}

inline int64_t round_up(int64_t v, int64_t q) { return (v + q - 1) / q * q; }

struct Args {
  const float* x;
  float* norms;
  float* panel;     // (min(items, kMaxItems), panel_rows, ldp) scratch
  const float* w;   // cohesion only
  float* out;
  int64_t n, d, n_valid, panel_rows;
  int64_t items;    // the chunk's items (of one group: group())
  pald::Params p;
  cudaStream_t stream;
  bool add = false;  // cohesion: every W finite, the predicated form

  int64_t ldp() const { return round_up(n, kTile); }
  int64_t pitem() const { return panel_rows * ldp(); }

  dim3 grid() const {
    const unsigned t = static_cast<unsigned>((n + kTile - 1) / kTile);
    return dim3(t, t, static_cast<unsigned>(items));
  }

  // items [i0, i0 + b) of the chunk: the operands advanced, the panel
  // buffer shared (the groups run one after another on the stream)
  Args group(int64_t i0, int64_t b) const {
    Args g = *this;
    g.x += i0 * n * d;
    g.norms += i0 * n;
    if (g.w) g.w += i0 * n * n;
    g.out += i0 * n * n;
    g.items = b;
    return g;
  }
};

// the norms of the chunk's items b n rows, once
template <int M>
int launch_norms(const Args& a) {
  return pald::launch_row_norms<M>(a.x, a.norms, a.items * a.n, a.d,
                                   a.stream);
}

// rows [p0, p0 + pn) of each item's D into its slab of the panel
template <int M, bool kItems>
int launch_panel(const Args& a, int64_t p0, int64_t pn) {
  const int64_t ldp = a.ldp();
  const dim3 grid(static_cast<unsigned>(ldp / kTile),
                  static_cast<unsigned>((pn + kTile - 1) / kTile),
                  static_cast<unsigned>(a.items));
  dist_fused_kernel<M, kItems><<<grid, kThreads, 0, a.stream>>>(
      a.x, a.norms, a.panel, ldp, a.pitem(), p0, pn, ldp, a.n, a.d,
      a.n_valid);
  return static_cast<int>(cudaGetLastError());
}

// For each group of up to kMaxItems items and each panel: the panel
// writer, then pass(group, p0, pn) over every tile of every item.
template <int M, bool kItems, class Kernel, class Pass>
int run_panels(const Args& a, Kernel kernel, int smem, Pass&& pass) {
  int status = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  for (int64_t i0 = 0; status == 0 && i0 < a.items; i0 += kMaxItems) {
    const Args g =
        a.group(i0, a.items - i0 < kMaxItems ? a.items - i0 : kMaxItems);
    for (int64_t p0 = 0; status == 0 && p0 < g.n; p0 += g.panel_rows) {
      const int64_t pn = g.n - p0 < g.panel_rows ? g.n - p0 : g.panel_rows;
      status = launch_panel<M, kItems>(g, p0, pn);
      if (status == 0) {
        pass(g, p0, pn);
        status = static_cast<int>(cudaGetLastError());
      }
    }
  }
  return status;
}

template <int M, bool kItems>
struct FocusLaunch {
  const Args& a;
  template <class F>
  int operator()() const {
    const auto kernel = focus_fused_kernel<M, F, kItems>;
    constexpr int smem = sizeof(FocusSmem);
    return run_panels<M, kItems>(
        a, kernel, smem, [&](const Args& g, int64_t p0, int64_t pn) {
          kernel<<<g.grid(), kThreads, smem, g.stream>>>(
              g.x, g.norms, g.panel, g.out, g.n, g.d, g.n_valid, g.ldp(),
              g.pitem(), p0, pn, g.p);
        });
  }
};

template <int M, bool kItems>
struct CohesionLaunch {
  const Args& a;
  template <class F, bool kAdd>
  int launch() const {
    const auto kernel = cohesion_fused_kernel<M, F, kAdd, kItems>;
    constexpr int smem = sizeof(CohesionSmem);
    return run_panels<M, kItems>(
        a, kernel, smem, [&](const Args& g, int64_t p0, int64_t pn) {
          kernel<<<g.grid(), kThreads, smem, g.stream>>>(
              g.x, g.norms, g.panel, g.w, g.out, g.n, g.d, g.n_valid,
              g.ldp(), g.pitem(), p0, pn, g.p);
        });
  }
  template <class F>
  int operator()() const {
    if constexpr (F::kPredicated) {
      if (a.add) return this->template launch<F, true>();
    }
    return this->template launch<F, false>();
  }
};

template <template <int, bool> class Pass, bool kItems>
struct PerMetric {
  const Args& a;
  int wid;
  template <int M>
  int operator()() const {
    const int status = launch_norms<M>(a);
    if (status != 0) return status;
    return pald::dispatch_weight(wid, Pass<M, kItems>{a});
  }
};

struct DistPerMetric {
  const Args& a;
  template <int M>
  int operator()() const {
    const int status = launch_norms<M>(a);
    if (status != 0) return status;
    dist_fused_kernel<M, false><<<a.grid(), kThreads, 0, a.stream>>>(
        a.x, a.norms, a.out, a.n, 0, 0, a.n, a.n, a.n, a.d, a.n_valid);
    return static_cast<int>(cudaGetLastError());
  }
};

inline bool bad_shape(int64_t n, int64_t d, int64_t n_valid,
                      int64_t items) {
  return n < 1 || d < 0 || n_valid < 0 || n_valid > n || items < 1 ||
         (n + kTile - 1) / kTile > 65535;
}

inline bool bad_panel(int64_t panel_rows) {
  return panel_rows < kTile || panel_rows % kTile != 0;
}


// U (items, n, n) from `items` row-major contiguous float32 X (n, d), one
// after another, for `metric` (0 sqeuclidean, 1 euclidean, 2 cosine, 3
// manhattan) and weight family `wid` with parameters p0, p1; rows at
// index >= n_valid of each item are padding.  `norms` is an (items, n)
// float32 scratch buffer, `panel` a (min(items, 65535), panel_rows, ldp)
// one, ldp = n rounded up to a multiple of 64, panel_rows a positive
// multiple of 64.  Issues the norms pre-pass (all metrics but manhattan),
// then, for each group of up to 65535 items, a panel and a pass grid per
// panel, on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown metric or family, or a shape out of range).  kItems: the
// kernels' chunk variants, the item on blockIdx.z (one item: without).
template <bool kItems>
int focus_fused(const float* x, float* norms, float* panel, float* u,
                int64_t n, int64_t d, int64_t n_valid, int64_t panel_rows,
                int64_t items, int metric, int wid, float p0, float p1,
                void* stream) {
  if (bad_shape(n, d, n_valid, items) || bad_panel(panel_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, panel, nullptr, u, n, d, n_valid, panel_rows,
               items, {p0, p1}, static_cast<cudaStream_t>(stream)};
  return pald::dispatch_metric(metric,
                               PerMetric<FocusLaunch, kItems>{a, wid});
}

// C (items, n, n) from X (items, n, d) and the weights W = 1/U (items, n,
// n); as focus_fused, and `add` != 0 says every W of the chunk is finite
// (the predicated form).  The index tiebreak of `ignore` is the global
// x > y within each item.
template <bool kItems>
int cohesion_fused(const float* x, float* norms, float* panel,
                   const float* w, float* c, int64_t n, int64_t d,
                   int64_t n_valid, int64_t panel_rows, int64_t items,
                   int metric, int wid, float p0, float p1, int add,
                   void* stream) {
  if (bad_shape(n, d, n_valid, items) || bad_panel(panel_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, panel, w, c, n, d, n_valid, panel_rows, items,
               {p0, p1}, static_cast<cudaStream_t>(stream), add != 0};
  return pald::dispatch_metric(metric,
                               PerMetric<CohesionLaunch, kItems>{a, wid});
}

}  // namespace pald::fused
