// PaLD pass 2 on Hopper, upper-triangular block schedule: cohesion
//
//     x-role:  C[x, z] += support(D[x, z], D[y, z], D[x, y], x > y) * W[x, y]
//     y-role:  C[y, z] += support(D[y, z], D[x, z], D[x, y], y > x) * W[x, y]
//
// for x in row block X, y in row block Y, over the nb(nb+1)/2 block pairs
// X <= Y of the nb = ceil(n / 64) row blocks: both roles on every
// off-diagonal pair, the x-role alone on a diagonal pair (it covers both
// orders of the pairs inside the block).  Only the upper tiles D[X, Y] and
// W[X, Y] are read: D and W are taken as symmetric, as the reference does.
//
// Replaces the TPU kernel repro/kernels/pald_cohesion_tri.py::
// cohesion_tri_pallas (body _cohesion_tri_kernel).
//
// What bounds it on the H100: operations.  Every ordered (x, y, z) triple
// is still evaluated once (the two roles of an unordered pair are two
// evaluations), so the work is the dense kernel's: ~4 FP32 lane
// instructions per triple, ~65 ms at n = 8192.
//
// Design.  The TPU kernel keeps a row block of Cx resident across
// consecutive grid steps and the y-role in a resident (n, block_z) Cy
// slab, which works because its grid runs in order.  Here thread blocks run
// in no order, and the y-roles of one row block Y come from every X < Y.
// So the pairs run in diagonal waves, one grid launch per wave: wave s
// takes the pairs (X, X + s), one thread block per (pair, 64-column z
// tile).  Within a wave no two thread blocks write the same rows of Cx
// (rows X) or of Cy (rows X + s); the waves run in stream order.  Each
// output entry is therefore summed by one thread, in one fixed order
// (Cx over Y = X, X+1, ...; Cy over X = Y-1, Y-2, ...), with no atomics:
// two calls give the same bits.  Wave 0 writes Cx (every row block has a
// diagonal pair); later waves read, add and write their 64 x 64 tiles of
// Cx and Cy (Cy starts at zero: row block 0 has no y-role).  C = Cx + Cy
// is one elementwise add afterwards.  Cost beyond the dense kernel: nb
// launches, and 4 x 64 x 64 floats read and written per (pair, z tile),
// ~69 GB at n = 8192, which other thread blocks' compute can hide.
//
// Inside a thread block the two roles run one after the other, each the
// dense kernel's loop (pald_tile.cuh: 256 threads with 4 x 4 outputs and
// their own distances in registers, the partner rows staged in slabs of
// 32, two-level sums), each in its own non-inlined function so that it
// keeps the dense loop's register allocation.  The x-role stages DXY and W
// transposed ([y][x]), the y-role stages the same tiles as they lie
// ([x][y]), so each reads four pair distances and weights as one float4.  The roles share the
// pair's tiles but no comparison: own < other of one role and other < own
// of the other are evaluated by different threads (the x-role's outputs
// are (x, z), the y-role's (y, z)), and sharing them would need a
// cross-thread sum of y-role partials per y, more shared-memory traffic
// than the compares it saves.
//
// The index tiebreak of families that need one (ignore): off the diagonal
// every x index is below every y index, so the x-role never wins a tie and
// the y-role always does; both run with the tiebreak as a compile-time
// constant.  A diagonal pair stages the per-entry "x > y" bytes as the
// dense kernel does.
//
// Ragged edges are masked (a partner row past n is never visited, rows /
// columns past n are never stored); 64-bit offsets.
#include "pald_tile.cuh"

namespace {

using pald::kLd;
using pald::kSlab;
using pald::kThreads;
using pald::kTile;

// The three ways a thread block applies a role to its 64-column z tile
enum Role : int {
  kDiagX = 0,  // diagonal pair: x-role, per-entry tiebreak, writes Cx
  kOffX = 1,   // off-diagonal pair: x-role, x never wins a tie, adds to Cx
  kOffY = 2,   // off-diagonal pair: y-role, y always wins a tie, adds to Cy
};

// One role on rows own0.. (X for the x-roles, Y for the y-role) against
// the partner rows of the other block, for columns z0..z0+63:
//   out[r, z] (+)= sum_q support(D[r, z], D[q, z], D[x, y], r wins) W[x, y]
// with (x, y) the pair (r, q) read from the upper tile.  __noinline__: each
// role gets the dense kernel's register allocation (inlined together, the
// two roles of an off-diagonal pair needed up to 160 registers a thread,
// one thread block per SM).
template <class F, int R>
__device__ __noinline__ void role_tile(
    const float* __restrict__ d, const float* __restrict__ w,
    float* __restrict__ out, int64_t n, int64_t x0, int64_t y0, int64_t z0,
    float (*syz)[kTile], float (*sxy)[kLd], float (*sw)[kLd],
    uint8_t (*sxw)[kLd], pald::Params p) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t own0 = R == kOffY ? y0 : x0;   // the rows this role sums to
  const int64_t q0 = R == kOffY ? x0 : y0;     // the partner rows
  const int64_t qe = n - q0 < kTile ? n : q0 + kTile;

  float own[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = own0 + ty * 4 + i, z = z0 + tx * 4 + j;
      own[i][j] = (r < n && z < n) ? d[r * n + z] : 0.f;
      acc[i][j] = 0.f;
    }
  for (int64_t qs = q0; qs < qe; qs += kSlab) {
    const int qn = static_cast<int>(qe - qs < kSlab ? qe - qs : kSlab);
    // D[qs:qs+qn, z0:z0+64] as it lies (a warp reads 32 consecutive z)
    for (int e = tid; e < kSlab * kTile; e += kThreads) {
      const int c = e / kTile, col = e % kTile;
      const int64_t z = z0 + col;
      syz[c][col] = (c < qn && z < n) ? d[(qs + c) * n + z] : 0.f;
    }
    bool all = R == kOffY, any = R == kOffY;
    if constexpr (R == kOffY) {
      // D, W [qs:qs+qn, y0:y0+64] (rows x, columns y) as they lie
      for (int e = tid; e < kSlab * kTile; e += kThreads) {
        const int c = e / kTile, col = e % kTile;
        const int64_t y = y0 + col;
        const bool in = c < qn && y < n;
        sxy[c][col] = in ? d[(qs + c) * n + y] : 0.f;
        sw[c][col] = in ? w[(qs + c) * n + y] : 0.f;
      }
      __syncthreads();
    } else {
      // D, W (and on the diagonal the tiebreak) [x0:x0+64, qs:qs+qn]
      // transposed to [y][x]
      bool all_win = true, any_win = false;
      for (int e = tid; e < kTile * kSlab; e += kThreads) {
        const int r = e / kSlab, c = e % kSlab;
        const int64_t x = x0 + r, y = qs + c;
        const bool in = x < n && c < qn;
        sxy[c][r] = in ? d[x * n + y] : 0.f;
        sw[c][r] = in ? w[x * n + y] : 0.f;
        if constexpr (F::kTiebreak && R == kDiagX) {
          const bool win = in && x > y;
          sxw[c][r] = win;
          all_win &= !in || win;
          any_win |= win;
        }
      }
      if constexpr (F::kTiebreak && R == kDiagX) {
        all = __syncthreads_and(all_win);
        any = __syncthreads_or(any_win);
      } else {
        __syncthreads();
      }
    }
    pald::cohesion_slab<F>(syz, sxy, sw, sxw, qn, all, any, tx, ty, own, acc,
                           p);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = own0 + ty * 4 + i, z = z0 + tx * 4 + j;
      if (r < n && z < n) {
        if constexpr (R == kDiagX)
          out[r * n + z] = acc[i][j];
        else
          out[r * n + z] += acc[i][j];
      }
    }
}

// wave s: thread block (z tile, X) takes the pair (X, X + s)
template <class F, bool kDiag>
__global__ void __launch_bounds__(kThreads)
cohesion_tri_kernel(const float* __restrict__ d, const float* __restrict__ w,
                    float* __restrict__ cx, float* __restrict__ cy,
                    int64_t n, int64_t s, pald::Params p) {
  __shared__ __align__(16) float syz[kSlab][kTile];
  __shared__ __align__(16) float sxy[kSlab][kLd];
  __shared__ __align__(16) float sw[kSlab][kLd];
  __shared__ __align__(16) uint8_t
      sxw[F::kTiebreak && kDiag ? kSlab : 1][kLd];
  const int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t y0 = x0 + s * kTile;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTile;
  if constexpr (kDiag) {
    role_tile<F, kDiagX>(d, w, cx, n, x0, y0, z0, syz, sxy, sw, sxw, p);
  } else {
    role_tile<F, kOffX>(d, w, cx, n, x0, y0, z0, syz, sxy, sw, sxw, p);
    role_tile<F, kOffY>(d, w, cy, n, x0, y0, z0, syz, sxy, sw, sxw, p);
  }
}

struct CohesionTriLaunch {
  const float *d, *w;
  float *cx, *cy;
  int64_t n, nb;
  pald::Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    for (int64_t s = 0; s < nb; ++s) {
      const dim3 grid(static_cast<unsigned>(nb),
                      static_cast<unsigned>(nb - s));
      if (s == 0)
        cohesion_tri_kernel<F, true><<<grid, kThreads, 0, stream>>>(
            d, w, cx, cy, n, s, p);
      else
        cohesion_tri_kernel<F, false><<<grid, kThreads, 0, stream>>>(
            d, w, cx, cy, n, s, p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
};

}  // namespace

// The x-role sums into cx and the y-role sums into cy, both (n, n)
// row-major float32; C = cx + cy.  d and w are row-major contiguous
// symmetric float32 (n, n) (only their upper 64 x 64 tiles are read); cy
// must hold zeros on entry, cx is overwritten.  Weight family `wid` with
// parameters p0, p1.  Issues ceil(n / 64) launches on `stream` and returns
// the first cudaGetLastError() that is not 0 (cudaErrorInvalidValue for an
// unknown family or a grid too large).  n >= 1.
extern "C" int pald_cohesion_tri_f32(const float* d, const float* w,
                                     float* cx, float* cy, int64_t n,
                                     int wid, float p0, float p1,
                                     void* stream) {
  const int64_t nb = (n + kTile - 1) / kTile;
  if (n < 1 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const CohesionTriLaunch launch{d, w, cx, cy, n, nb, {p0, p1},
                                 static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, launch);
}
