// The cohesion kernel of PaLD's pass 2 on Hopper, shared by the dense
// (rectangular) entry point, pald_cohesion.cu, and the upper-triangular
// one, pald_cohesion_tri.cu:
//
//     C[x, z] = sum_y support(DXZ[x, z], DYZ[y, z], DXY[x, y], x > y) * W[x, y]
//
// What bounds it on the H100: operations.  Each ordered (x, y, z) triple
// costs two compares and an add (the strict families' predicated form,
// pald_weights.cuh), against 4 n^2 floats read and n^2 written: at n = 8192
// the 5.5e11 triples need tens of ms of the FP32 and ALU pipes and the
// memory ~0.3 ms.
//
// Design.  One thread block owns a 64 x 64 (x, z) C tile for the whole y
// loop: 256 threads with a 4 x 4 block of outputs each, their DXZ values in
// registers, the loops of pald_tile.cuh over y slabs of 32 staged in shared
// memory, two blocks a multiprocessor (128 registers a thread; one block
// with up to 255 registers ran slower for every family).  Staging is
// asynchronous and double-buffered: the copies of slab s + 1 are issued
// with cp.async right after the barrier that opens slab s, so they land
// while slab s runs.  DYZ[y][z] rows are copied as they lie.  DXY and W
// have to be transposed to [y][x]: their (64 x, 32 y) tiles land as they
// lie in 16-byte pieces (a warp reads four whole 128-byte rows), and after
// the barrier each thread moves 4 x 4 of them into the [y][x] slab, whose
// rows are swizzled (pald_tile.cuh: swz) so that the moves hit 32 distinct
// banks and the loop still reads 4 consecutive x as one float4; one more
// barrier.  Copying 4-byte pieces straight into [y][x] instead cost a
// quarter of the kernel's time at n = 8192 on an H100 (32 row segments a
// warp and 16 copies a thread per tile; PERF.md).  Shapes whose rows lose the 16-byte alignment
// (my or mz not a multiple of 4) take 4-byte pieces.
//
// kTri: the operands are one square symmetric D (DXZ = DYZ = DXY) and a
// symmetric W, of which only the upper pair tiles are read: a slab of y
// wholly below the x tile (y < x0) takes its pair tile from D[y, x],
// W[y, x] as it lies (the same [y][x] layout, no transpose); the others
// read D[x, y], W[x, y] above or on the diagonal, as the dense kernel does.
// Every C[x, z] is then the dense kernel's sum, term for term and in the
// same order: on a symmetric D and W the two give bitwise the same C.
//
// The index tiebreak of families that need one (ignore): "global x index
// > global y index", from an explicit (mx, my) bool operand, whose bytes
// are staged with every slab, or, when that pointer is null, from the
// global indices plus (row_off, col_off): then a slab knows from its
// corners whether every / no in-range pair has x winning, and only the
// slabs across the diagonal stage bytes.  A slab where every in-range pair
// has the same value runs the loop with it as a compile-time constant.
//
// Ragged edges are masked: y past my is never visited (the last slab loops
// to its own length), x / z past the edge read zero-filled copies and are
// never stored.  64-bit offsets.
//
// A chunk of items (the engine's batch= chunks): blockIdx.z is the item,
// whose operands and C lie one item's extent past the previous one's
// (DXZ and C mx mz elements, DYZ my mz, DXY, W and the bool tiebreak
// mx my); every item has the same shape.  Each item's block runs exactly
// what a one-item grid's does, so a chunk's C is bitwise its items' one
// at a time; `add` is one flag for the chunk, and the predicated sum is
// bitwise the multiply form's on a finite W, so a chunk with a non-finite
// W changes no finite item's bits.  CohesionLaunch issues one grid per
// 65535 items (gridDim.z).  A one-item call takes the kChunk = false
// instantiation, with no item offsets: held in registers, the six shifted
// pointers cost the dense kernel 1.5 ms of 93 at n = 8192 on an H100
// (PERF.md).
#pragma once

#include <cstdint>

#include "pald_tile.cuh"

namespace pald {

struct CohesionSmem {
  float syz[2][kSlab][kTile];
  float sxy[2][kSlab][kTile];  // swizzled rows (pald_tile.cuh: swz)
  float sw[2][kSlab][kTile];
  float lxy[kTile][kSlab];     // DXY and W tiles as they lie, to transpose
  float lw[kTile][kSlab];
  uint8_t sxw[2][kSlab][kLd];
};

// rows [r0, r0 + rn) x columns [c0, c0 + 64) of a row-major matrix with row
// stride ld into s[r][0:64] as they lie (kSwz: into swizzled rows), columns
// past nc as zeros; vec: 16-byte pieces (ld and nc multiples of 4, src
// 16-byte aligned), else 4-byte ones
template <bool kSwz, int Ld>
__device__ __forceinline__ void stage_rows(float (*s)[Ld],
                                           const float* __restrict__ src,
                                           int64_t ld, int64_t r0, int rn,
                                           int64_t c0, int64_t nc, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int kPieces = kTile / 4;
    for (int e = tid; e < kSlab * kPieces; e += kThreads) {
      const int r = e / kPieces, q = e % kPieces;
      const int64_t c = c0 + q * 4;
      if (r < rn)
        cp_async16(&s[r][(kSwz ? q ^ swz(r) : q) * 4],
                   c < nc ? src + (r0 + r) * ld + c : src, c < nc ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kSlab * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const int64_t c = c0 + col;
      if (r < rn)
        cp_async4(&s[r][kSwz ? swizzled(r, col) : col],
                  c < nc ? src + (r0 + r) * ld + c : src, c < nc ? 4 : 0);
    }
  }
}

// The tile [r0, r0 + 64) x [c0, c0 + cn) of a row-major matrix with row
// stride ld, bound for a swizzled [c][r] slab; rows past nr as zeros.
// vec (ld a multiple of 4, src 16-byte aligned): copied as it lies into
// land[r][c] in 16-byte pieces (a warp reads four whole 128-byte rows), for
// transpose() to move; else straight into s[c][r] in 4-byte pieces.
__device__ __forceinline__ void stage_cols(float (*s)[kTile],
                                           float (*land)[kSlab],
                                           const float* __restrict__ src,
                                           int64_t ld, int64_t r0, int64_t nr,
                                           int64_t c0, int cn, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int kPieces = kSlab / 4;
    for (int e = tid; e < kTile * kPieces; e += kThreads) {
      const int r = e / kPieces, q = e % kPieces;
      const bool in = r0 + r < nr && q * 4 < cn;
      cp_async16(&land[r][q * 4], in ? src + (r0 + r) * ld + c0 + q * 4 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e % kTile, c = e / kTile;
      const bool in = r0 + r < nr;
      if (c < cn)
        cp_async4(&s[c][swizzled(c, r)], in ? src + (r0 + r) * ld + c0 + c : src,
                  in ? 4 : 0);
    }
  }
}

// land[r][c] (staged by stage_cols) into the swizzled s[c][r]: a thread
// moves 4 consecutive c of one r; a warp reads 8 whole 16-byte pieces a
// row and writes 4 x 8 patches, all conflict-free
__device__ __forceinline__ void transpose(float (*s)[kTile],
                                          float (*land)[kSlab], int tid) {
  constexpr int kPieces = kSlab / 4;
  for (int e = tid; e < kTile * kPieces; e += kThreads) {
    const int q = e % kPieces, r = e / kPieces;
    const float4 v = *reinterpret_cast<const float4*>(&land[r][q * 4]);
    s[q * 4 + 0][swizzled(q * 4 + 0, r)] = v.x;
    s[q * 4 + 1][swizzled(q * 4 + 1, r)] = v.y;
    s[q * 4 + 2][swizzled(q * 4 + 2, r)] = v.z;
    s[q * 4 + 3][swizzled(q * 4 + 3, r)] = v.w;
  }
}

template <class F, bool kAdd, bool kTri, bool kChunk>
__global__ void __launch_bounds__(kThreads, 2)
cohesion_kernel(const float* __restrict__ dxz, const float* __restrict__ dyz,
                const float* __restrict__ dxy, const float* __restrict__ w,
                const uint8_t* __restrict__ xw, float* __restrict__ c,
                int64_t mx, int64_t my, int64_t mz, int64_t row_off,
                int64_t col_off, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  CohesionSmem& sm = *reinterpret_cast<CohesionSmem*>(smem);
  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.z;
    dxz += item * mx * mz;
    dyz += item * my * mz;
    dxy += item * mx * my;
    w += item * mx * my;
    if (xw) xw += item * mx * my;
    c += item * mx * mz;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // tile-local indices in 32 bits (the grid's limit keeps them there),
  // element offsets in 64
  const int x0 = blockIdx.y * kTile, z0 = blockIdx.x * kTile;
  const bool vec_yz = mz % 4 == 0 && aligned16(dyz);
  // the pair tiles' rows keep their 16-byte alignment
  const bool vec_xy = my % 4 == 0 && aligned16(dxy) && aligned16(w);

  float own[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, z = z0 + tx * 4 + j;
      own[i][j] = (x < mx && z < mz) ? dxz[x * mz + z] : 0.f;
      acc[i][j] = 0.f;
    }

  // kTri: a slab of y wholly below the x tile reads the upper tile as it lies
  auto as_lies = [&](int y0) { return kTri && y0 + kSlab <= x0; };
  // whether the slab at y0 lands as it lies and is transposed in place
  auto landed = [&](int y0) { return vec_xy && !as_lies(y0); };

  // issue the copies of the slab at y0 into buffer b, and set this
  // thread's view of its tiebreak: x wins for all / any in-range pair
  auto stage = [&](int y0, int b, bool& all_w, bool& any_w) {
    const int yn = static_cast<int>(my - y0 < kSlab ? my - y0 : kSlab);
    stage_rows<false>(sm.syz[b], dyz, mz, y0, yn, z0, mz, vec_yz, tid);
    all_w = true;
    any_w = false;
    if (as_lies(y0)) {
      // below the diagonal (square: mx = my = n): every x > y
      stage_rows<true>(sm.sxy[b], dxy, mx, y0, yn, x0, mx, vec_xy, tid);
      stage_rows<true>(sm.sw[b], w, mx, y0, yn, x0, mx, vec_xy, tid);
      any_w = true;
      return;
    }
    stage_cols(sm.sxy[b], sm.lxy, dxy, my, x0, mx, y0, yn, vec_xy, tid);
    stage_cols(sm.sw[b], sm.lw, w, my, x0, mx, y0, yn, vec_xy, tid);
    if constexpr (F::kTiebreak) {
      const int64_t x_last = (x0 + kTile < mx ? x0 + kTile : mx) - 1;
      if (!xw) {
        all_w = row_off + x0 > col_off + y0 + yn - 1;
        any_w = row_off + x_last > col_off + y0;
        if (all_w || !any_w) return;  // no per-entry bytes to stage
      }
      for (int e = tid; e < kTile * kSlab; e += kThreads) {
        const int r = e / kSlab, col = e % kSlab;
        const int64_t x = x0 + r, y = y0 + col;
        const bool in = x < mx && col < yn;
        const bool win = in && (xw ? xw[x * my + y] != 0
                                   : row_off + x > col_off + y);
        sm.sxw[b][col][r] = win;
        if (xw) {
          all_w &= !in || win;
          any_w |= win;
        }
      }
    }
  };

  const int slabs = static_cast<int>((my + kSlab - 1) / kSlab);
  bool all_w = true, any_w = false;
  if (slabs > 0) stage(0, 0, all_w, any_w);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    const int b = s & 1;
    const int y0 = s * kSlab;
    const int yn = static_cast<int>(my - y0 < kSlab ? my - y0 : kSlab);
    cp_async_wait<0>();
    // slab s has landed for every thread, and every thread is done with
    // slab s - 1, whose buffers the next copies reuse
    bool all = false, any = false;
    if constexpr (F::kTiebreak) {
      all = __syncthreads_and(all_w);
      any = __syncthreads_or(any_w);
    } else {
      __syncthreads();
    }
    if (landed(y0)) {
      transpose(sm.sxy[b], sm.lxy, tid);
      transpose(sm.sw[b], sm.lw, tid);
      __syncthreads();  // the slab is in place, the landing buffers free
    }
    if (s + 1 < slabs) stage(y0 + kSlab, b ^ 1, all_w, any_w);
    cp_async_commit();
    cohesion_slab<F, kAdd>(sm.syz[b], sm.sxy[b], sm.sw[b], sm.sxw[b], yn,
                           all, any, tx, ty, own, acc, p);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t x = x0 + ty * 4 + i, z = z0 + tx * 4 + j;
      if (x < mx && z < mz) c[x * mz + z] = acc[i][j];
    }
}

struct CohesionArgs {
  const float *dxz, *dyz, *dxy, *w;
  const uint8_t* xw;
  float* c;
  int64_t mx, my, mz, row_off, col_off;
  int64_t items;  // the chunk's items, one after another
  Params p;
  bool add;  // W is finite: the predicated form, where the family has one
  cudaStream_t stream;
};

template <class F, bool kAdd, bool kTri>
int launch_cohesion(const CohesionArgs& a) {
  const auto kernel = a.items > 1 ? cohesion_kernel<F, kAdd, kTri, true>
                                  : cohesion_kernel<F, kAdd, kTri, false>;
  constexpr int smem = sizeof(CohesionSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int64_t kMaxItems = 65535;  // gridDim.z
  const int64_t sxz = a.mx * a.mz, syz = a.my * a.mz, sxy = a.mx * a.my;
  for (int64_t i0 = 0; i0 < a.items; i0 += kMaxItems) {
    const int64_t b = a.items - i0 < kMaxItems ? a.items - i0 : kMaxItems;
    const dim3 grid(static_cast<unsigned>((a.mz + kTile - 1) / kTile),
                    static_cast<unsigned>((a.mx + kTile - 1) / kTile),
                    static_cast<unsigned>(b));
    kernel<<<grid, kThreads, smem, a.stream>>>(
        a.dxz + i0 * sxz, a.dyz + i0 * syz, a.dxy + i0 * sxy,
        a.w + i0 * sxy, a.xw ? a.xw + i0 * sxy : nullptr, a.c + i0 * sxz,
        a.mx, a.my, a.mz, a.row_off, a.col_off, a.p);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  return static_cast<int>(cudaSuccess);
}

// one grid of cohesion_kernel<F, ...> for the family F (dispatch_weight)
template <bool kTri>
struct CohesionLaunch {
  const CohesionArgs& a;

  template <class F>
  int operator()() const {
    if constexpr (F::kPredicated) {
      if (a.add) return launch_cohesion<F, true, kTri>(a);
    }
    return launch_cohesion<F, false, kTri>(a);
  }
};

}  // namespace pald
