// PaLD pass 1 on Hopper: local-focus sizes
//
//     U[x, y] = sum_z focus(DXZ[x, z], DYZ[y, z], DXY[x, y])
//
// Replaces the TPU kernels repro/kernels/pald_focus.py::focus_general_pallas
// (body _focus_kernel) and repro/kernels/pald_focus_tri.py::focus_tri_pallas
// (body _focus_tri_kernel).  The TPU kernel keeps U[X, Y] resident across a
// sequential z grid axis; here one thread block owns a U tile for the whole
// z loop.  Two entry points, one kernel (pald_focus.cuh; the loop is in
// pald_tile.cuh, shared with pald_fused.cu):
//   pald_focus_f32         rectangular DXZ (mx, mz), DYZ (my, mz) and DXY
//                          (mx, my), every tile of U;
//   pald_focus_square_f32  one square D as all three operands (what the
//                          dense and the upper-triangular schedule's pass 1
//                          pass): a block per upper tile pair, each tile
//                          mirrored into U[Y, X] when its thresholds are
//                          symmetric, else its mirror computed from D[y, x]
//                          in a second z loop.  On a symmetric D that is
//                          half the dense grid's triples, and U is bitwise
//                          the rectangular entry's U on the same D.  This
//                          replaces the tri TPU kernel's packed (npairs, b,
//                          b) buffer and the scatter that mirrored it.
// Both take `counts`: null, or two device counters, [0] gaining one for
// each thread block that ran and [1] one for each off-diagonal tile pair
// whose thresholds were not symmetric (square entry).  The square entry
// takes a chunk of `items` square D, one after another (the engine's
// batch= chunks), in one grid: the item is blockIdx.z.  What bounds the
// kernel and its design are in pald_focus.cuh.
#include "pald_focus.cuh"

// U (mx, my) from row-major contiguous float32 DXZ (mx, mz), DYZ (my, mz),
// DXY (mx, my); weight family `wid` with parameters p0, p1.  Launches one
// grid of (mx/64) x (my/64) tiles on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown family or a grid
// too large).  mx, my >= 1.
extern "C" int pald_focus_f32(const float* dxz, const float* dyz,
                              const float* dxy, float* u, int64_t mx,
                              int64_t my, int64_t mz,
                              unsigned long long* counts, int wid, float p0,
                              float p1, void* stream) {
  if (mx < 1 || my < 1 || mz < 0 ||
      (mx + pald::kTile - 1) / pald::kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const pald::FocusArgs a{dxz, dyz, dxy, u, mx, my, mz, 1, counts, {p0, p1},
                          static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, pald::FocusLaunch<false>{a});
}

// U (items, n, n) from `items` row-major contiguous float32 D (n, n), one
// after another, any D; weight family `wid` with parameters p0, p1.
// Launches one grid of nb (nb + 1) / 2 x items blocks (nb = ceil(n / 64);
// one more grid per 65535 items) on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown family or a
// grid too large).  n, items >= 1.
extern "C" int pald_focus_square_f32(const float* d, float* u, int64_t n,
                                     int64_t items,
                                     unsigned long long* counts, int wid,
                                     float p0, float p1, void* stream) {
  const int64_t nb = (n + pald::kTile - 1) / pald::kTile;
  if (n < 1 || items < 1 || nb * (nb + 1) / 2 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const pald::FocusArgs a{d, d, d, u, n, n, n, items, counts, {p0, p1},
                          static_cast<cudaStream_t>(stream)};
  return pald::dispatch_weight(wid, pald::FocusLaunch<true>{a});
}
