// PaLD pass 2 on Hopper: cohesion accumulation
//
//     C[x, z] = sum_y support(DXZ[x, z], DYZ[y, z], DXY[x, y], x > y) * W[x, y]
//
// Replaces the TPU kernel repro/kernels/pald_cohesion.py::
// cohesion_general_pallas (bodies _cohesion_kernel, _cohesion_kernel_xw and
// _cohesion_kernel_iota) in its rectangular form: DXZ (mx, mz), DYZ
// (my, mz), DXY and W (mx, my) are separate operands.  W = 1/U is computed
// outside, once.
//
// What bounds it on the H100: operations.  Each (x, y, z) triple costs two
// compares, the tie term and a multiply-add (~4 FP32 lane instructions),
// against 4 n^2 floats read and n^2 written, so at n = 8192 the n^3 = 5.5e11
// triples need ~65 ms of the FP32 pipe and ~0.3 ms of memory traffic.
//
// Design.  The TPU kernel keeps C[X, Z] resident across a sequential
// y grid axis; here one thread block owns a 64 x 64 (x, z) C tile for the
// whole y loop.  256 threads each hold a 4 x 4 block of outputs and the 16
// DXZ values of those outputs in registers.  y is streamed in slabs of 32:
// DYZ[y][z] is staged as it lies, DXY and W transposed to [y][x], so per y a
// thread reads its 4 DYZ, 4 DXY and 4 W values as one float4 each and does
// 16 weight evaluations.  The weight family is a template parameter
// (pald_weights.cuh); the loop is in pald_tile.cuh, shared with the fused
// kernel (pald_fused.cu).
//
// The index tiebreak of families that need one (ignore): per slab, the
// "global x index > global y index" bytes are staged in shared memory too,
// either copied from an explicit (mx, my) bool operand (the TPU kernel's
// XW route) or, when that pointer is null, derived from the global indices
// plus (row_off, col_off) (the TPU kernel's iota route).  One kernel covers
// both; families without a tiebreak skip the staging at compile time.  A
// slab whose bytes are all equal (every slab off the diagonal, on the
// square path) runs a loop with the tiebreak as a compile-time constant;
// only the others read the bytes per entry.
//
// Sums are two-level: a thread adds a slab's 32 terms into a partial and the
// partial into its accumulator.  One running float32 sum over n = 8192
// terms of similar size drifts far more: each small term is rounded against
// a large total (see PERF.md for the error measured against a float64 sum).
//
// Ragged edges are masked here: a y past my is never visited (the last slab
// loops to its own length, so it contributes exactly 0), and x / z past the
// edge are computed from filler values and never stored.  64-bit offsets.
#include "pald_tile.cuh"

namespace {

using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

template <class F>
__global__ void __launch_bounds__(kThreads)
cohesion_kernel(const float* __restrict__ dxz, const float* __restrict__ dyz,
                const float* __restrict__ dxy, const float* __restrict__ w,
                const uint8_t* __restrict__ xw, float* __restrict__ c,
                int64_t mx, int64_t my, int64_t mz, int64_t row_off,
                int64_t col_off, pald::Params p) {
  __shared__ __align__(16) float syz[kSlab][kTile];
  __shared__ __align__(16) float sxy[kSlab][kLd];
  __shared__ __align__(16) float sw[kSlab][kLd];
  __shared__ __align__(16) uint8_t sxw[F::kTiebreak ? kSlab : 1][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTile;

  float own[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, z = z0 + tx * 4 + j;
      own[i][j] = (x < mx && z < mz) ? dxz[x * mz + z] : 0.f;
      acc[i][j] = 0.f;
    }

  for (int64_t y0 = 0; y0 < my; y0 += kSlab) {
    const int yn = static_cast<int>(my - y0 < kSlab ? my - y0 : kSlab);
    // DYZ[y0:y0+yn, z0:z0+64] as it lies (a warp reads 32 consecutive z)
    for (int e = tid; e < kSlab * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const int64_t y = y0 + r, z = z0 + col;
      syz[r][col] = (r < yn && z < mz) ? dyz[y * mz + z] : 0.f;
    }
    // DXY, W (and the tiebreak) [x0:x0+64, y0:y0+yn] transposed to [y][x]
    bool all_win = true, any_win = false;
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, col = e % kSlab;
      const int64_t x = x0 + r, y = y0 + col;
      const bool in = x < mx && col < yn;
      sxy[col][r] = in ? dxy[x * my + y] : 0.f;
      sw[col][r] = in ? w[x * my + y] : 0.f;
      if constexpr (F::kTiebreak) {
        const bool win = in && (xw ? xw[x * my + y] != 0
                                   : row_off + x > col_off + y);
        sxw[col][r] = win;
        all_win &= !in || win;
        any_win |= win;
      }
    }
    // a slab off the diagonal has one tiebreak value for all its (x, y)
    // pairs (the syncs also close the staging)
    bool all = false, any = false;
    if constexpr (F::kTiebreak) {
      all = __syncthreads_and(all_win);
      any = __syncthreads_or(any_win);
    } else {
      __syncthreads();
    }
    pald::cohesion_slab<F>(syz, sxy, sw, sxw, yn, all, any, tx, ty, own, acc,
                           p);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, z = z0 + tx * 4 + j;
      if (x < mx && z < mz) c[x * mz + z] = acc[i][j];
    }
}

struct CohesionLaunch {
  const float *dxz, *dyz, *dxy, *w;
  const uint8_t* xw;
  float* c;
  int64_t mx, my, mz, row_off, col_off;
  pald::Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    const dim3 grid(static_cast<unsigned>((mz + kTile - 1) / kTile),
                    static_cast<unsigned>((mx + kTile - 1) / kTile));
    cohesion_kernel<F><<<grid, kThreads, 0, stream>>>(
        dxz, dyz, dxy, w, xw, c, mx, my, mz, row_off, col_off, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// C (mx, mz) from row-major contiguous float32 DXZ (mx, mz), DYZ (my, mz),
// DXY and W (mx, my); `xw` is an optional (mx, my) bool tiebreak (null:
// derive x > y from row_off + x > col_off + y).  Weight family `wid` with
// parameters p0, p1.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown family or a grid too large).
// mx, mz >= 1.
extern "C" int pald_cohesion_f32(const float* dxz, const float* dyz,
                                 const float* dxy, const float* w,
                                 const uint8_t* xw, float* c, int64_t mx,
                                 int64_t my, int64_t mz, int64_t row_off,
                                 int64_t col_off, int wid, float p0, float p1,
                                 void* stream) {
  if (mx < 1 || mz < 1 || my < 0 || (mx + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CohesionLaunch launch{dxz, dyz, dxy, w, xw, c, mx, my, mz, row_off,
                              col_off, {p0, p1},
                              static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, launch);
}
