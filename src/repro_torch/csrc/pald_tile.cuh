// The inner triple loops of PaLD's two passes, shared by the dense kernels
// (pald_focus.cu, pald_cohesion.cu) and the fused ones (pald_fused.cu).
//
// A thread block owns a 64 x 64 output tile and streams the reduced axis
// in slabs of 32 staged in shared memory; each of its 256 threads holds a
// 4 x 4 block of outputs and their fixed operand (the threshold d_xy of
// focus, the own distance d_xz of cohesion) in registers.  The kernels
// differ only in how a slab is staged: loaded from a distance matrix
// (dense) or computed from feature rows (fused).  The loops are the same
// code, so on the same distances the two give bitwise the same sums.
//
// Slab layouts (rows of kLd floats, 16-byte aligned):
//   focus:    sx[z][x], sy[z][y]          (a thread reads x = ty*4.., y = tx*4..)
//   cohesion: syz[y][z], sxy[y][x], sw[y][x], sxw[y][x] (bytes)
//             (a thread reads z = tx*4.., x = ty*4..)
#pragma once

#include "pald_weights.cuh"

namespace pald {

constexpr int kTile = 64;          // output tile edge
constexpr int kSlab = 32;          // reduced-axis values staged per step
constexpr int kLd = kTile + 4;     // padded row of a staged slab
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

template <class F>
__device__ __forceinline__ void focus_step(const float* sx, const float* sy,
                                           int tx, int ty,
                                           const float (&thr)[4][4],
                                           float (&acc)[4][4],
                                           const Params& p) {
  const float4 a = *reinterpret_cast<const float4*>(sx + ty * 4);
  const float4 b = *reinterpret_cast<const float4*>(sy + tx * 4);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += F::focus(av[i], bv[j], thr[i][j], p);
}

// one staged focus slab of zn <= kSlab z values, summed into a partial
// and the partial into acc (the two-level sum)
template <class F>
__device__ __forceinline__ void focus_slab(float (*sx)[kLd],
                                           float (*sy)[kLd], int zn,
                                           int tx, int ty,
                                           const float (&thr)[4][4],
                                           float (&acc)[4][4],
                                           const Params& p) {
  float part[4][4] = {};
  if (zn == kSlab) {
#pragma unroll 8
    for (int c = 0; c < kSlab; ++c)
      focus_step<F>(sx[c], sy[c], tx, ty, thr, part, p);
  } else {
    for (int c = 0; c < zn; ++c)
      focus_step<F>(sx[c], sy[c], tx, ty, thr, part, p);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// how the x > y tiebreak varies over one staged slab: the same for every
// (x, y) of the slab (all win / none wins), or per entry
enum Tie : int { kNoneWins = 0, kAllWin = 1, kPerEntry = 2 };

template <class F, int T>
__device__ __forceinline__ void cohesion_step(const float* syz,
                                              const float* sxy,
                                              const float* sw,
                                              const uint8_t* sxw, int tx,
                                              int ty, const float (&own)[4][4],
                                              float (&acc)[4][4],
                                              const Params& p) {
  const float4 o = *reinterpret_cast<const float4*>(syz + tx * 4);
  const float4 d = *reinterpret_cast<const float4*>(sxy + ty * 4);
  const float4 w = *reinterpret_cast<const float4*>(sw + ty * 4);
  const float ov[4] = {o.x, o.y, o.z, o.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
  bool wins[4] = {T == kAllWin, T == kAllWin, T == kAllWin, T == kAllWin};
  if constexpr (T == kPerEntry) {
    const uchar4 b = *reinterpret_cast<const uchar4*>(sxw + ty * 4);
    wins[0] = b.x; wins[1] = b.y; wins[2] = b.z; wins[3] = b.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += F::support(own[i][j], ov[j], dv[i], wins[i], p) * wv[i];
}

// one staged slab of yn <= kSlab y values into the partial sums
template <class F, int T, int LdYZ>
__device__ __forceinline__ void cohesion_slab_as(
    float (*syz)[LdYZ], float (*sxy)[kLd], float (*sw)[kLd],
    uint8_t (*sxw)[kLd], int yn, int tx, int ty,
    const float (&own)[4][4], float (&part)[4][4], const Params& p) {
  if (yn == kSlab) {
#pragma unroll 8
    for (int y = 0; y < kSlab; ++y)
      cohesion_step<F, T>(syz[y], sxy[y], sw[y], sxw[T == kPerEntry ? y : 0],
                          tx, ty, own, part, p);
  } else {
    for (int y = 0; y < yn; ++y)
      cohesion_step<F, T>(syz[y], sxy[y], sw[y], sxw[T == kPerEntry ? y : 0],
                          tx, ty, own, part, p);
  }
}

// one staged cohesion slab, summed into a partial and the partial into
// acc.  `all` / `any`: whether every / some in-range (x, y) pair of the
// slab has x winning the tiebreak (block-uniform; ignored by families
// without one).  A slab off the diagonal has one tiebreak value for all
// its pairs and runs a loop with it as a compile-time constant; only the
// others read the staged bytes per entry.
template <class F, int LdYZ>
__device__ __forceinline__ void cohesion_slab(
    float (*syz)[LdYZ], float (*sxy)[kLd], float (*sw)[kLd],
    uint8_t (*sxw)[kLd], int yn, bool all, bool any, int tx, int ty,
    const float (&own)[4][4], float (&acc)[4][4], const Params& p) {
  float part[4][4] = {};
  if constexpr (F::kTiebreak) {
    if (all)
      cohesion_slab_as<F, kAllWin>(syz, sxy, sw, sxw, yn, tx, ty, own, part,
                                   p);
    else if (any)
      cohesion_slab_as<F, kPerEntry>(syz, sxy, sw, sxw, yn, tx, ty, own,
                                     part, p);
    else
      cohesion_slab_as<F, kNoneWins>(syz, sxy, sw, sxw, yn, tx, ty, own,
                                     part, p);
  } else {
    cohesion_slab_as<F, kNoneWins>(syz, sxy, sw, sxw, yn, tx, ty, own, part,
                                   p);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

}  // namespace pald
