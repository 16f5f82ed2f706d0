// PaLD pass 1 on Hopper, upper-triangular block schedule: local-focus sizes
//
//     U[x, y] = sum_z focus(D[x, z], D[y, z], D[x, y])      (D symmetric)
//
// Replaces the TPU kernel repro/kernels/pald_focus_tri.py::focus_tri_pallas
// (body _focus_tri_kernel).  U is symmetric, so only the nb(nb+1)/2 tile
// pairs X <= Y of the nb = ceil(n / 64) row blocks are computed: about half
// the n^3 triples of the dense kernel (pald_focus.cu).
//
// What bounds it on the H100: operations, as for the dense kernel.  Each
// (x, y, z) triple costs a min, a compare and an add (3 FP32 lane
// instructions for the strict families); at n = 8192 the
// nb(nb+1)/2 * 64^2 * n = 2.8e11 triples need ~25 ms of the card's FP32
// lanes, against ~0.5 ms of memory traffic (D read, U written once).
//
// Design.  One thread block per upper pair (X, Y), found from blockIdx.x
// by a closed-form triangular index (pairs numbered column by column,
// t = Y (Y + 1) / 2 + X).  The block runs the dense kernel's z loop
// unchanged (pald_tile.cuh: a 64 x 64 tile, 256 threads with 4 x 4 outputs
// and their thresholds D[x, y] in registers, z staged in slabs of 32,
// two-level sums), then stores the tile at U[X, Y] and, off the diagonal,
// its transpose at U[Y, X].  This replaces the TPU kernel's packed
// (npairs, b, b) buffer and the scatter that mirrored it.  A diagonal
// block holds both orders of every pair inside it, so it stores its tile
// once (writing the transpose too would race between its threads).  The
// transposed stores are uncoalesced (a warp writes 16 rows 4 floats
// apart): n^2 / 2 scattered 4-byte writes, small beside the triple loop.
//
// Exactness.  The tile at (X, Y) is the dense kernel's tile at (X, Y), op
// for op.  Every family's focus(a, b, t) is symmetric in a and b (a min of
// the two), and D[y, x] == D[x, y], so the mirrored entry is also the
// dense kernel's U[y, x]: U is bitwise the dense kernel's for a symmetric
// D.  Ragged edges are masked (a z past n is never visited, x / y past n
// are never stored); 64-bit offsets.
#include <cmath>

#include "pald_tile.cuh"

namespace {

using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

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

template <class F>
__global__ void __launch_bounds__(kThreads)
focus_tri_kernel(const float* __restrict__ d, float* __restrict__ u,
                 int64_t n, pald::Params p) {
  __shared__ __align__(16) float sx[kSlab][kLd];
  __shared__ __align__(16) float sy[kSlab][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int64_t bx, by;
  tri_pair(blockIdx.x, bx, by);
  const int64_t x0 = bx * kTile, y0 = by * kTile;

  float thr[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      thr[i][j] = (x < n && y < n) ? d[x * n + y] : 0.f;
      acc[i][j] = 0.f;
    }

  for (int64_t z0 = 0; z0 < n; z0 += kSlab) {
    const int zn = static_cast<int>(n - z0 < kSlab ? n - z0 : kSlab);
    // D[x0:x0+64, z0:z0+zn] and D[y0:y0+64, ...] transposed; a warp reads
    // 32 consecutive z of one row (coalesced)
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, c = e % kSlab;
      const int64_t x = x0 + r, y = y0 + r, z = z0 + c;
      sx[c][r] = (x < n && c < zn) ? d[x * n + z] : 0.f;
      sy[c][r] = (y < n && c < zn) ? d[y * n + z] : 0.f;
    }
    __syncthreads();
    pald::focus_slab<F>(sx, sy, zn, tx, ty, thr, acc, p);
    __syncthreads();
  }

  const bool mirror = bx != by;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, y = y0 + tx * 4 + j;
      if (x < n && y < n) {
        u[x * n + y] = acc[i][j];
        if (mirror) u[y * n + x] = acc[i][j];
      }
    }
}

struct FocusTriLaunch {
  const float* d;
  float* u;
  int64_t n, npairs;
  pald::Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    focus_tri_kernel<F><<<static_cast<unsigned>(npairs), kThreads, 0,
                          stream>>>(d, u, n, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// U (n, n) from a row-major contiguous symmetric float32 D (n, n); weight
// family `wid` with parameters p0, p1.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown family or a
// grid too large).  n >= 1.
extern "C" int pald_focus_tri_f32(const float* d, float* u, int64_t n,
                                  int wid, float p0, float p1, void* stream) {
  const int64_t nb = (n + kTile - 1) / kTile;
  const int64_t npairs = nb * (nb + 1) / 2;
  if (n < 1 || npairs > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const FocusTriLaunch launch{d, u, n, npairs, {p0, p1},
                              static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, launch);
}
