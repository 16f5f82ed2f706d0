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
// Slab layouts (rows of kLd floats, 16-byte aligned, unless said):
//   focus:    sx[z][x], sy[z][y]          (a thread reads x = ty*4.., y = tx*4..)
//   cohesion: syz[y][z], sxy[y][x] and sw[y][x] (rows of kTile floats,
//             swizzled: swz), sxw[y][x] (bytes)
//             (a thread reads z = tx*4.., x = ty*4..)
//
// Cohesion sums.  Every C[x, z] is summed over y ascending: the 32 terms of
// a slab into a partial, the partial into the accumulator (two-level).  The
// families with a predicated form (pald_weights.cuh) add W under the
// predicate when the caller says W is finite (kAdd), bitwise the multiply
// form's sum; the per-entry tiebreak slabs of `ignore` (the diagonal, about
// 1 % of the slabs at n = 8192) keep the multiply form.  So every kernel
// that runs these loops on the same numbers, with the same kAdd, gives
// bitwise the same C.
#pragma once

#include "pald_weights.cuh"

namespace pald {

constexpr int kTile = 64;          // output tile edge
constexpr int kSlab = 32;          // reduced-axis values staged per step
constexpr int kLd = kTile + 4;     // padded row of a staged slab
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

// ---- asynchronous copies into shared memory (sm_80+) ----------------------
// `bytes` below the copy's size fills the rest of it with zeros (0: nothing
// is read from src)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Cohesion's [y][x] slabs (sxy, sw) are rows of kTile floats whose 16-byte
// chunks are permuted per row: chunk c of row y lies at c ^ swz(y).  A warp
// that stores a 4 x 8 (x, y) patch transposed then hits 32 banks, and the
// loop still reads a thread's 4 consecutive x as one float4.
__host__ __device__ constexpr int swz(int y) { return (y >> 2) & 7; }

// where x of row y lies in a swizzled [y][x] row
__device__ __forceinline__ int swizzled(int y, int x) {
  return (((x >> 2) ^ swz(y)) << 2) | (x & 3);
}

// one y of a staged slab, the multiply form: syz the slab's DYZ row, xy4
// and w4 this thread's 4 x of its swizzled DXY and W rows, xw4 its 4
// tiebreak bytes (kPerEntry)
template <class F, int T>
__device__ __forceinline__ void cohesion_step(const float* syz,
                                              const float* xy4,
                                              const float* w4,
                                              const uint8_t* xw4, int tx,
                                              const float (&own)[4][4],
                                              float (&acc)[4][4],
                                              const Params& p) {
  const float4 o = *reinterpret_cast<const float4*>(syz + tx * 4);
  const float4 d = *reinterpret_cast<const float4*>(xy4);
  const float4 w = *reinterpret_cast<const float4*>(w4);
  const float ov[4] = {o.x, o.y, o.z, o.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
  bool wins[4] = {T == kAllWin, T == kAllWin, T == kAllWin, T == kAllWin};
  if constexpr (T == kPerEntry) {
    const uchar4 b = *reinterpret_cast<const uchar4*>(xw4);
    wins[0] = b.x; wins[1] = b.y; wins[2] = b.z; wins[3] = b.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += F::support(own[i][j], ov[j], dv[i], wins[i], p) * wv[i];
}

// one y of a staged slab, the predicated form (finite W); kLe: own wins
// every tie of the slab
template <class F, bool kLe>
__device__ __forceinline__ void cohesion_step_add(const float* syz,
                                                  const float* xy4,
                                                  const float* w4, int tx,
                                                  const float (&own)[4][4],
                                                  float (&acc)[4][4],
                                                  const Params& p) {
  const float4 o = *reinterpret_cast<const float4*>(syz + tx * 4);
  const float4 d = *reinterpret_cast<const float4*>(xy4);
  const float4 w = *reinterpret_cast<const float4*>(w4);
  const float ov[4] = {o.x, o.y, o.z, o.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      F::template add<kLe>(acc[i][j], own[i][j], ov[j], dv[i], wv[i], p);
}

// the yn <= kSlab y of one staged slab into the partial sums, in the
// multiply form (T) or the predicated form (kAdd, kLe); 8 y unrolled, in
// groups of 4 that share their swizzled column
template <class F, bool kAdd, bool kLe, int T, int LdYZ>
__device__ __forceinline__ void cohesion_slab_as(
    float (*syz)[LdYZ], float (*sxy)[kTile], float (*sw)[kTile],
    uint8_t (*sxw)[kLd], int yn, int tx, int ty, const float (&own)[4][4],
    float (&part)[4][4], const Params& p) {
  auto step = [&](int y, int cx) {
    if constexpr (kAdd)
      cohesion_step_add<F, kLe>(syz[y], sxy[y] + cx, sw[y] + cx, tx, own,
                                part, p);
    else
      cohesion_step<F, T>(syz[y], sxy[y] + cx, sw[y] + cx,
                          sxw[T == kPerEntry ? y : 0] + ty * 4, tx, own,
                          part, p);
  };
  if (yn == kSlab) {
#pragma unroll 2
    for (int y4 = 0; y4 < kSlab; y4 += 4) {
      const int cx = (ty ^ swz(y4)) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) step(y4 + u, cx);
    }
  } else {
    for (int y = 0; y < yn; ++y) step(y, (ty ^ swz(y)) * 4);
  }
}

// one staged cohesion slab, summed into a partial and the partial into
// acc.  `all` / `any`: whether every / some in-range (x, y) pair of the
// slab has x winning the tiebreak (block-uniform; ignored by families
// without one).  A slab off the diagonal has one tiebreak value for all
// its pairs and runs a loop with it as a compile-time constant (in the
// predicated form, `<=` or `<`); only the others read the staged bytes per
// entry.  kAdd: the predicated form (F::kPredicated, every W finite).
template <class F, bool kAdd, int LdYZ>
__device__ __forceinline__ void cohesion_slab(
    float (*syz)[LdYZ], float (*sxy)[kTile], float (*sw)[kTile],
    uint8_t (*sxw)[kLd], int yn, bool all, bool any, int tx, int ty,
    const float (&own)[4][4], float (&acc)[4][4], const Params& p) {
  float part[4][4] = {};
  if constexpr (kAdd) {
    static_assert(F::kPredicated, "kAdd needs the family's predicated form");
  }
  if constexpr (F::kTiebreak) {
    if (all)
      cohesion_slab_as<F, kAdd, true, kAllWin>(syz, sxy, sw, sxw, yn, tx, ty,
                                               own, part, p);
    else if (any)
      cohesion_slab_as<F, false, false, kPerEntry>(syz, sxy, sw, sxw, yn, tx,
                                                   ty, own, part, p);
    else
      cohesion_slab_as<F, kAdd, false, kNoneWins>(syz, sxy, sw, sxw, yn, tx,
                                                  ty, own, part, p);
  } else {
    cohesion_slab_as<F, kAdd, false, kNoneWins>(syz, sxy, sw, sxw, yn, tx, ty,
                                                own, part, p);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

}  // namespace pald
