// PaLD pass 2 on Hopper: cohesion accumulation, rectangular operands
//
//     C[x, z] = sum_y support(DXZ[x, z], DYZ[y, z], DXY[x, y], x > y) * W[x, y]
//
// Replaces the TPU kernel repro/kernels/pald_cohesion.py::
// cohesion_general_pallas (bodies _cohesion_kernel, _cohesion_kernel_xw and
// _cohesion_kernel_iota) in its rectangular form: DXZ (mx, mz), DYZ
// (my, mz), DXY and W (mx, my) are separate operands.  W = 1/U is computed
// outside, once.  The TPU kernel keeps C[X, Z] resident across a sequential
// y grid axis; here one thread block owns a C tile for the whole y loop.
// The kernel, what bounds it and its design are in pald_cohesion.cuh
// (shared with the upper-triangular entry point, pald_cohesion_tri.cu); the
// loops are in pald_tile.cuh (shared with pald_fused.cu).
//
// The index tiebreak of families that need one (ignore) comes from an
// explicit (mx, my) bool operand (the TPU kernel's XW route) or, when that
// pointer is null, from the global indices plus (row_off, col_off) (the
// TPU kernel's iota route).
#include "pald_cohesion.cuh"

// C (items, mx, mz) from `items` row-major contiguous float32 DXZ (mx, mz),
// DYZ (my, mz), DXY and W (mx, my), each operand's items one after
// another (the engine's batch= chunks, one grid for all: the item is
// blockIdx.z); `xw` is an optional (items, mx, my) bool tiebreak (null:
// derive x > y from row_off + x > col_off + y).  Weight family `wid` with
// parameters p0, p1; `add` != 0 says every W of the chunk is finite (the
// predicated form).  Launches one grid (one more per 65535 items) on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown family or a grid too large).  mx, mz, items >= 1.
extern "C" int pald_cohesion_f32(const float* dxz, const float* dyz,
                                 const float* dxy, const float* w,
                                 const uint8_t* xw, float* c, int64_t mx,
                                 int64_t my, int64_t mz, int64_t items,
                                 int64_t row_off, int64_t col_off, int wid,
                                 float p0, float p1, int add, void* stream) {
  if (mx < 1 || mz < 1 || my < 0 || items < 1 ||
      (mx + pald::kTile - 1) / pald::kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const pald::CohesionArgs a{dxz, dyz, dxy, w, xw, c, mx, my, mz, row_off,
                             col_off, items, {p0, p1}, add != 0,
                             static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, pald::CohesionLaunch<false>{a});
}
