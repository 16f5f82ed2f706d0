// PaLD pass 2 on Hopper, upper-triangular block schedule: cohesion from the
// upper tiles of a symmetric D and W
//
//     C[x, z] = sum_y support(D[x, z], D[y, z], D[x, y], x > y) * W[x, y]
//
// with every pair tile D[X, Y], W[X, Y] read from the upper triangle:
// D[min(X, Y), max(X, Y)].
//
// Replaces the TPU kernel repro/kernels/pald_cohesion_tri.py::
// cohesion_tri_pallas (body _cohesion_tri_kernel).  The TPU kernel visits
// the block pairs X <= Y and applies both role updates per off-diagonal
// pair, keeping a row block of Cx resident across consecutive grid steps
// and the y-roles in a resident (n, block_z) Cy slab, which works because
// its grid runs in order.  Here blocks run in no order, so the kernel is
// the dense one (pald_cohesion.cuh, kTri): a thread block owns C[R, Z] for
// a row block R and walks the partner rows in ascending order, in the role
// each takes against R: below R a y-role (the upper tile D[Q, R] as it
// lies; R wins every tie), on the diagonal its own tile (per-entry
// tiebreak), above R an x-role (the upper tile D[R, Q] transposed; R wins
// no tie).  One grid, C written once: no Cx / Cy pair, no read-modify-write,
// no wave per diagonal.
//
// What it saves, honestly: pass 2 still evaluates every ordered triple,
// the dense kernel's work (sharing the compares of the two roles of a pair
// would save no instruction: a shared min, focus test and two predicated
// compares are the 6 per unordered pair that two predicated x-roles
// cost).  The tri schedule's gain is pass 1, which it halves.  On a
// symmetric D and W this C is bitwise the dense kernel's (the same terms
// in the same order).
#include "pald_cohesion.cuh"

// C (items, n, n) row-major float32 from `items` row-major contiguous
// symmetric float32 d and w (n, n), one after another (the engine's
// batch= chunks, one grid for all: the item is blockIdx.z), of which only
// the upper 64 x 64 pair tiles are read.  Weight family `wid` with
// parameters p0, p1; `add` != 0 says every W of the chunk is finite (the
// predicated form).  Launches one grid (one more per 65535 items) on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown family or a grid too large).  n, items >= 1.
extern "C" int pald_cohesion_tri_f32(const float* d, const float* w,
                                     float* c, int64_t n, int64_t items,
                                     int wid, float p0, float p1, int add,
                                     void* stream) {
  if (n < 1 || items < 1 || (n + pald::kTile - 1) / pald::kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const pald::CohesionArgs a{d, d, d, w, nullptr, c, n, n, n, 0, 0, items,
                             {p0, p1}, add != 0,
                             static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, pald::CohesionLaunch<true>{a});
}
