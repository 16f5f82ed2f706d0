// PaLD pass 1 on Hopper: local-focus sizes
//
//     U[x, y] = sum_z focus(DXZ[x, z], DYZ[y, z], DXY[x, y])
//
// Replaces the TPU kernel repro/kernels/pald_focus.py::focus_general_pallas
// (body _focus_kernel), in its rectangular form: DXZ (mx, mz), DYZ (my, mz)
// and DXY (mx, my) are separate operands, so nothing assumes a symmetric D.
//
// What bounds it on the H100: operations.  Each (x, y, z) triple costs a
// min, a compare and an add (3 FP32 lane instructions for the strict
// families) and the data are only 3 n^2 floats read and n^2 written, so at
// n = 8192 the n^3 = 5.5e11 triples need ~50 ms of the card's 128 FP32
// lanes x 132 SMs, against ~0.3 ms of memory traffic.
//
// Design.  The TPU kernel keeps U[X, Y] resident across a sequential
// z grid axis; here one thread block owns a 64 x 64 U tile for the whole
// z loop, register-blocked like an SGEMM: 256 threads, each with a 4 x 4
// block of outputs and their 16 DXY thresholds in registers.  z is streamed
// in slabs of 32, staged transposed in shared memory ([z][x] and [z][y], so
// a thread reads its 4 x and 4 y values as one float4 each).  Per z a thread
// issues 2 shared loads for 16 weight evaluations, so the loop is bound by
// the FP32 pipe, not by shared memory.  The weight family is a template
// parameter (pald_weights.cuh): no branch on it inside the loop.  The loop
// itself is in pald_tile.cuh, shared with the fused kernel (pald_fused.cu),
// which stages the same slabs computed from feature rows.
//
// Ragged edges are masked here, not padded by the caller: a z past mz is
// never visited (the last slab loops to its own length, so it contributes
// exactly 0 for every family, +inf thresholds included), and x / y past the
// edge are computed from filler values and never stored.  U is summed in
// float32 like the TPU kernel: strict counts stay exact integers below 2^24.
// The sum is two-level (a slab's 32 terms into a partial, the partial into
// the accumulator), which keeps the smooth families' sums accurate at large
// n, as in pald_cohesion.cu.  Global offsets are 64-bit (n^2 overflows int32
// above n = 46340).
#include "pald_tile.cuh"

namespace {

using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

template <class F>
__global__ void __launch_bounds__(kThreads)
focus_kernel(const float* __restrict__ dxz, const float* __restrict__ dyz,
             const float* __restrict__ dxy, float* __restrict__ u,
             int64_t mx, int64_t my, int64_t mz, pald::Params p) {
  __shared__ __align__(16) float sx[kSlab][kLd];
  __shared__ __align__(16) float sy[kSlab][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t y0 = static_cast<int64_t>(blockIdx.x) * kTile;

  float thr[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      thr[i][j] = (x < mx && y < my) ? dxy[x * my + y] : 0.f;
      acc[i][j] = 0.f;
    }

  for (int64_t z0 = 0; z0 < mz; z0 += kSlab) {
    const int zn = static_cast<int>(mz - z0 < kSlab ? mz - z0 : kSlab);
    // stage DXZ[x0:x0+64, z0:z0+zn] and DYZ[y0:y0+64, ...] transposed;
    // a warp reads 32 consecutive z of one row (coalesced)
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, c = e % kSlab;
      const int64_t x = x0 + r, y = y0 + r, z = z0 + c;
      sx[c][r] = (x < mx && c < zn) ? dxz[x * mz + z] : 0.f;
      sy[c][r] = (y < my && c < zn) ? dyz[y * mz + z] : 0.f;
    }
    __syncthreads();
    pald::focus_slab<F>(sx, sy, zn, tx, ty, thr, acc, p);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      if (x < mx && y < my) u[x * my + y] = acc[i][j];
    }
}

struct FocusLaunch {
  const float *dxz, *dyz, *dxy;
  float* u;
  int64_t mx, my, mz;
  pald::Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    const dim3 grid(static_cast<unsigned>((my + kTile - 1) / kTile),
                    static_cast<unsigned>((mx + kTile - 1) / kTile));
    focus_kernel<F><<<grid, kThreads, 0, stream>>>(dxz, dyz, dxy, u, mx, my,
                                                   mz, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// U (mx, my) from row-major contiguous float32 DXZ (mx, mz), DYZ (my, mz),
// DXY (mx, my); weight family `wid` with parameters p0, p1.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown family or a grid too large).  mx, my >= 1.
extern "C" int pald_focus_f32(const float* dxz, const float* dyz,
                              const float* dxy, float* u, int64_t mx,
                              int64_t my, int64_t mz, int wid, float p0,
                              float p1, void* stream) {
  if (mx < 1 || my < 1 || mz < 0 || (mx + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FocusLaunch launch{dxz, dyz, dxy, u, mx, my, mz, {p0, p1},
                           static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, launch);
}
