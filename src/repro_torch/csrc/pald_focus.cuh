// The focus kernel of PaLD's pass 1 on Hopper, behind the entry points of
// pald_focus.cu (rectangular operands, and one square D: the dense and the
// upper-triangular schedule's pass 1):
//
//     U[x, y] = sum_z focus(DXZ[x, z], DYZ[y, z], DXY[x, y])
//
// What bounds it on the H100: operations.  Each (x, y, z) triple costs a
// min, a compare and an add (FMNMX, FSETP, FADD for the strict families),
// the first two on the ALU pipe at half the FP32 rate, against 3 n^2 floats
// read and n^2 written: at n = 8192 the n (n + 1) / 2 * n unordered triples
// need ~33 ms of the ALU pipe and the memory ~0.3 ms.
//
// Design.  One thread block owns a 64 x 64 U tile for the whole z loop:
// 256 threads with a 4 x 4 block of outputs each and their thresholds
// DXY[x, y] in registers, the loop of pald_tile.cuh (focus_slab, shared
// with the fused kernel, pald_fused.cu) over z slabs of 32, two blocks a
// multiprocessor.  Staging: the rows DXZ[x0:x0+64, z0:z0+32] and
// DYZ[y0:y0+64, ...] land as they lie in 16-byte cp.async pieces (a warp
// reads four whole 128-byte rows): slab s + 1's right after the barrier
// that opens slab s's loop, so they land while it runs (two stages: the
// landing buffer and the loop's slabs).  After the next barrier each
// thread moves whole 16-byte pieces into the [z][x] / [z][y]
// slabs the loop reads (a warp reads 32 rows of the landing buffer, whose
// padded rows put them in distinct banks, and writes 32 consecutive x of
// one z: no conflict); one more barrier.  Rows whose 16-byte alignment is
// lost (mz not a multiple of 4) land in 4-byte pieces.
//
// The grids (a template parameter):
//   rectangular  every tile of the (mx, my) grid, U[x, y] stored as
//                computed;
//   square       one square D (DXZ = DYZ = DXY; the dense and the tri
//                schedule): a block per upper tile pair X <= Y (closed-form
//                triangular index).  Every family's focus(a, b, t) is
//                symmetric in a and b, so U[y, x] is the tile's own sum
//                wherever D[y, x] has the bits of D[x, y]: the block tests
//                that for its whole tile (one __syncthreads_and) and then
//                stores the tile and its transpose.  A tile that fails the
//                test runs the z loop a second time with the thresholds
//                D[y, x] over the same rows and stores that as U[y, x] (it
//                adds one to counts[1]): exact for any D, with no host-side
//                test.  A diagonal tile holds both orders of every pair in
//                it: it stores once.
// Either grid's thread 0 of each block adds one to counts[0], so the caller
// reads the blocks that ran, not the grid it asked for.
//
// A chunk of items (the engine's batch= chunks): blockIdx.z is the item,
// whose operands and U lie one item's extent (mx mz, my mz, mx my
// elements) past the previous one's; every item has the same shape.  Each
// item's block runs exactly what a one-item grid's does, so a chunk's U is
// bitwise its items' one at a time, and counts[0] reads items x the grid.
// A launch holds up to 65535 items (gridDim.z); FocusLaunch issues one
// grid per 65535.
// So on a symmetric D the two give bitwise the same U, term for term and
// in the same order (z ascending, two-level sums), as the fused kernel
// does on the same distances.
//
// Ragged edges are masked: a z past mz is never visited (the last slab
// loops to its own length), x / y past the edge read zero-filled copies and
// are never stored.  64-bit element offsets.
#pragma once

#include <cmath>
#include <cstdint>

#include "pald_tile.cuh"

namespace pald {

constexpr int kLand = kSlab + 4;  // padded landing row: 8 rows, 32 banks

struct FocusSmem {
  float sx[kSlab][kLd];    // the loop's [z][x] and [z][y] slabs
  float sy[kSlab][kLd];
  float lx[kTile][kLand];  // the next slab's rows, as they lie
  float ly[kTile][kLand];
};

// (X, Y), X <= Y, of upper pair t = Y (Y + 1) / 2 + X
__device__ __forceinline__ void tri_pair(int64_t t, int64_t& bx,
                                         int64_t& by) {
  int64_t y = static_cast<int64_t>(
      (sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (y * (y + 1) / 2 > t) --y;          // the double root may round up
  while ((y + 1) * (y + 2) / 2 <= t) ++y;   // ... or down
  by = y;
  bx = t - y * (y + 1) / 2;
}

// issue the copies of rows [r0, r0 + 64) x columns [z0, z0 + 32) of a
// row-major matrix with row stride ld into land[r][c]; rows past nr and
// columns past nz as zeros.  vec: 16-byte pieces (ld a multiple of 4, src
// 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void land_rows(float (*land)[kLand],
                                          const float* __restrict__ src,
                                          int64_t ld, int64_t r0, int64_t nr,
                                          int64_t z0, int64_t nz, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int kPieces = kSlab / 4;
    for (int e = tid; e < kTile * kPieces; e += kThreads) {
      const int r = e / kPieces, q = e % kPieces;
      const bool in = r0 + r < nr && z0 + q * 4 < nz;
      cp_async16(&land[r][q * 4], in ? src + (r0 + r) * ld + z0 + q * 4 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, c = e % kSlab;
      const bool in = r0 + r < nr && z0 + c < nz;
      cp_async4(&land[r][c], in ? src + (r0 + r) * ld + z0 + c : src,
                in ? 4 : 0);
    }
  }
}

// land[r][c] into the loop's s[c][r]: a thread moves one 16-byte piece
// (4 c of one r); a warp holds 32 consecutive r of one piece column
__device__ __forceinline__ void land_to_slab(float (*s)[kLd],
                                             float (*land)[kLand], int tid) {
  constexpr int kPieces = kSlab / 4;
  for (int e = tid; e < kTile * kPieces; e += kThreads) {
    const int r = e % kTile, q = e / kTile;
    const float4 v = *reinterpret_cast<const float4*>(&land[r][q * 4]);
    s[q * 4 + 0][r] = v.x;
    s[q * 4 + 1][r] = v.y;
    s[q * 4 + 2][r] = v.z;
    s[q * 4 + 3][r] = v.w;
  }
}

// the whole z loop of one tile: acc[i][j] += sum_z focus(DXZ[x, z],
// DYZ[y, z], thr[i][j]) for x = x0 + ty*4 + i, y = y0 + tx*4 + j.  Starts
// and ends with the landing buffers free.
template <class F>
__device__ __forceinline__ void focus_sweep(
    FocusSmem& sm, const float* __restrict__ dxz,
    const float* __restrict__ dyz, int64_t x0, int64_t y0, int64_t mx,
    int64_t my, int64_t mz, bool vec, int tid, int tx, int ty,
    const float (&thr)[4][4], float (&acc)[4][4], const Params& p) {
  const int64_t slabs = (mz + kSlab - 1) / kSlab;
  if (slabs == 0) return;
  land_rows(sm.lx, dxz, mz, x0, mx, 0, mz, vec, tid);
  land_rows(sm.ly, dyz, mz, y0, my, 0, mz, vec, tid);
  cp_async_commit();
  for (int64_t s = 0; s < slabs; ++s) {
    const int64_t z0 = s * kSlab;
    const int zn = static_cast<int>(mz - z0 < kSlab ? mz - z0 : kSlab);
    cp_async_wait<0>();
    // slab s has landed for every thread, and every thread is done with
    // slab s - 1's loop, whose [z][x] slabs the moves overwrite
    __syncthreads();
    land_to_slab(sm.sx, sm.lx, tid);
    land_to_slab(sm.sy, sm.ly, tid);
    __syncthreads();  // the slab is in place, the landing buffers free
    if (s + 1 < slabs) {
      land_rows(sm.lx, dxz, mz, x0, mx, z0 + kSlab, mz, vec, tid);
      land_rows(sm.ly, dyz, mz, y0, my, z0 + kSlab, mz, vec, tid);
      cp_async_commit();
    }
    focus_slab<F>(sm.sx, sm.sy, zn, tx, ty, thr, acc, p);
  }
}

// this thread's 4 x 4 of a tile into U (row stride ld): at U[x, y], or
// transposed at U[y, x]; vec: 16-byte stores (ld a multiple of 4, u
// 16-byte aligned)
__device__ __forceinline__ void store_tile(float* __restrict__ u, int64_t ld,
                                           int64_t x0, int64_t y0, int64_t mx,
                                           int64_t my, int tx, int ty,
                                           const float (&acc)[4][4],
                                           bool transposed, bool vec) {
  const int64_t xb = x0 + ty * 4, yb = y0 + tx * 4;
  if (!transposed) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t x = xb + i;
      if (x >= mx) break;
      if (vec && yb + 3 < my) {
        *reinterpret_cast<float4*>(u + x * ld + yb) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (yb + j < my) u[x * ld + yb + j] = acc[i][j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t y = yb + j;
      if (y >= my) break;
      if (vec && xb + 3 < mx) {
        *reinterpret_cast<float4*>(u + y * ld + xb) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (xb + i < mx) u[y * ld + xb + i] = acc[i][j];
      }
    }
  }
}

// U[y, x] of an asymmetric off-diagonal tile pair (X, Y) of a square D
// (n, n): the same loop over the same rows, with the thresholds D[y, x].
// Out of line: inlined beside the common path it cost that path registers
// (ptxas: 52 B of spill stores and 196 B of loads for the strict families)
// and 6 % of its time on an H100.
template <class F>
__device__ __noinline__ void focus_reverse(FocusSmem& sm,
                                           const float* __restrict__ d,
                                           float* __restrict__ u, int64_t n,
                                           int64_t x0, int64_t y0, bool vec,
                                           bool vec_u, int tid, int tx,
                                           int ty, Params p) {
  float thr[4][4], acc[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      thr[i][j] = (x < n && y < n) ? d[y * n + x] : 0.f;
    }
  focus_sweep<F>(sm, d, d, x0, y0, n, n, n, vec, tid, tx, ty, thr, acc, p);
  store_tile(u, n, x0, y0, n, n, tx, ty, acc, true, vec_u);
}

template <class F, bool kSquare>
__global__ void __launch_bounds__(kThreads, 2)
focus_kernel(const float* __restrict__ dxz, const float* __restrict__ dyz,
             const float* __restrict__ dxy, float* __restrict__ u,
             int64_t mx, int64_t my, int64_t mz,
             unsigned long long* __restrict__ counts, Params p) {
  __shared__ __align__(16) FocusSmem sm;
  // this block's item of the chunk
  const int64_t item = blockIdx.z;
  dxz += item * mx * mz;
  dyz += item * my * mz;
  dxy += item * mx * my;
  u += item * mx * my;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int64_t bx, by;
  if constexpr (kSquare) {
    tri_pair(blockIdx.x, bx, by);
  } else {
    bx = blockIdx.y;
    by = blockIdx.x;
  }
  const int64_t x0 = bx * kTile, y0 = by * kTile;
  const bool vec = mz % 4 == 0 && aligned16(dxz) && aligned16(dyz);
  const bool vec_u = my % 4 == 0 && aligned16(u);
  const bool diag = kSquare && bx == by;
  if (tid == 0 && counts) atomicAdd(&counts[0], 1ull);

  // the thresholds; on a square D, whether each has its mirror's bits
  float thr[4][4];
  bool same = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      const bool in = x < mx && y < my;
      thr[i][j] = in ? dxy[x * my + y] : 0.f;
      if constexpr (kSquare)
        same &= !in || __float_as_uint(thr[i][j]) ==
                           __float_as_uint(dxy[y * my + x]);
    }
  // block-uniform: every operand of the && is the same for all threads
  const bool mirror = kSquare && !diag && __syncthreads_and(same);

  float acc[4][4] = {};
  focus_sweep<F>(sm, dxz, dyz, x0, y0, mx, my, mz, vec, tid, tx, ty, thr,
                 acc, p);
  store_tile(u, my, x0, y0, mx, my, tx, ty, acc, false, vec_u);
  if (mirror) store_tile(u, my, x0, y0, mx, my, tx, ty, acc, true, vec_u);
  if constexpr (kSquare) {
    if (!diag && !mirror) {  // an asymmetric tile pair: its mirror apart
      if (tid == 0 && counts) atomicAdd(&counts[1], 1ull);
      focus_reverse<F>(sm, dxy, u, mx, x0, y0, vec, vec_u, tid, tx, ty, p);
    }
  }
}

struct FocusArgs {
  const float *dxz, *dyz, *dxy;
  float* u;
  int64_t mx, my, mz;
  int64_t items;  // the chunk's items, one after another
  // null, or [0] blocks run, [1] asymmetric tile pairs (square grid)
  unsigned long long* counts;
  Params p;
  cudaStream_t stream;
};

constexpr int64_t kMaxItems = 65535;  // gridDim.z

// the grids of focus_kernel<F, kSquare> for the family F (dispatch_weight):
// every tile, or the upper tile pairs of a square D, for up to kMaxItems
// items each
template <bool kSquare>
struct FocusLaunch {
  const FocusArgs& a;

  template <class F>
  int operator()() const {
    unsigned gx, gy = 1;
    if constexpr (kSquare) {
      const int64_t nb = (a.mx + kTile - 1) / kTile;
      gx = static_cast<unsigned>(nb * (nb + 1) / 2);
    } else {
      gx = static_cast<unsigned>((a.my + kTile - 1) / kTile);
      gy = static_cast<unsigned>((a.mx + kTile - 1) / kTile);
    }
    for (int64_t i0 = 0; i0 < a.items; i0 += kMaxItems) {
      const int64_t b = a.items - i0 < kMaxItems ? a.items - i0 : kMaxItems;
      focus_kernel<F, kSquare>
          <<<dim3(gx, gy, static_cast<unsigned>(b)), kThreads, 0,
             a.stream>>>(a.dxz + i0 * a.mx * a.mz, a.dyz + i0 * a.my * a.mz,
                         a.dxy + i0 * a.mx * a.my, a.u + i0 * a.mx * a.my,
                         a.mx, a.my, a.mz, a.counts, a.p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  }
};

}  // namespace pald
