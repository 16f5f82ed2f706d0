// Sparse k-NN PaLD cohesion on Hopper: for every row x of the neighbor
// graph, the (k+1) values [self, nbr_0, ..., nbr_{k-1}] of
//
//     U[j]   = focus(0, dn[j], dn[j]) + sum_m focus(dn[m], g[j][m], dn[j])
//     W[j]   = U[j] > 0 ? 1 / U[j] : 0
//     out[0] = sum_j support(0, dn[j], dn[j], x > idx[j]) W[j]
//     out[1+m] = sum_j support(dn[m], g[j][m], dn[j], x > idx[j]) W[j]
//
// from dn (n, k) neighbor distances, g (n, k, k) gathered
// neighbor-to-neighbor distances and idx (n, k) neighbor indices.
// Replaces the TPU kernel repro/kernels/pald_knn.py::knn_values_pallas on
// the real k (no lane padding); the plain version is
// repro_torch/core/knn.py::knn_values_tile.  For a functional with a
// share (soft) the support is share(own, other) * focus(own, other, pair),
// the plain version's reuse of its focus cube, recomputed here.
//
// What bounds it on the H100: bytes.  Each row reads its k^2 floats of g
// once from device memory (g dominates: 205 MB at n = 50,000, k = 32)
// against ~7 lane instructions per (j, m) pair; U and W never leave the
// block.
//
// Design.  One warp per row, four rows per block of 128 threads; the row's
// dn, W and idx sit in shared memory (12 k bytes a warp, so k <= 1024
// fits the 48 KB of static-sized dynamic shared memory).  Pass 1 walks the
// pairs j in order: lane l sums the focus terms of m = l, l + 32, ... (the
// warp reads row j of g coalesced), a butterfly of shuffles adds the 32
// partial sums (every lane ends with the same bits), and lane 0 stores
// W[j].  Pass 2 gives each lane the column m = l + 32t and walks j in
// order, again reading row j of g coalesced (now from L1/L2), summing 32
// terms into a partial and the partial into the total (two-level, as the
// dense kernels do); the self column is one term per j, summed over the
// lanes as in pass 1.  Every weight is pald_weights.cuh's, bitwise torch's;
// only the order of the sums differs from the plain version, so the
// smooth families' U (and every value) agree to rounding, and the exact
// families' U bitwise.  64-bit offsets (n k^2 passes 2^31 at k = 32 past
// n = 2.1e6).
#include <cstdint>

#include "pald_weights.cuh"

namespace {

using pald::Params;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 1024;

// the support of z for the pair (x, y): the functional's own, or for a
// functional with a share (soft) share * focus on the same triple
template <class F>
struct KnnSupport {
  __device__ __forceinline__ static float eval(float own, float other,
                                               float pair, bool own_wins,
                                               const Params& p) {
    return F::support(own, other, pair, own_wins, p);
  }
};

template <>
struct KnnSupport<pald::Soft> {
  __device__ __forceinline__ static float eval(float own, float other,
                                               float pair, bool,
                                               const Params& p) {
    // clip(0.5 + (other - own) / (4 tau), 0, 1): soft's share
    const float share = pald::clip(
        __fadd_rn(0.5f, __fmul_rn(__fsub_rn(other, own), p.p1)), 0.f, 1.f);
    return __fmul_rn(share, pald::Soft::focus(own, other, pair, p));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

template <class F>
__global__ void __launch_bounds__(kThreads)
knn_values_kernel(const float* __restrict__ dn, const float* __restrict__ g,
                  const int* __restrict__ idx, float* __restrict__ out,
                  int64_t n, int k, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (x >= n) return;  // a whole warp: no block-wide barrier below
  float* sd = reinterpret_cast<float*>(smem) + warp * 3 * k;  // dn[x]
  float* sw = sd + k;                                         // W[x]
  int* si = reinterpret_cast<int*>(sw + k);                   // idx[x]
  const float* gx = g + x * static_cast<int64_t>(k) * k;
  for (int j = lane; j < k; j += 32) {
    sd[j] = dn[x * k + j];
    si[j] = idx[x * k + j];
  }
  __syncwarp();

  // pass 1: U[j] and W[j] for every pair (x, nbr_j)
  for (int j = 0; j < k; ++j) {
    const float dxy = sd[j];
    const float* gj = gx + static_cast<int64_t>(j) * k;
    float part = 0.f;
    for (int m = lane; m < k; m += 32)
      part = __fadd_rn(part, F::focus(sd[m], gj[m], dxy, p));
    const float u = __fadd_rn(F::focus(0.f, dxy, dxy, p), warp_sum(part));
    if (lane == 0) sw[j] = u > 0.f ? __fdiv_rn(1.f, u) : 0.f;
  }
  __syncwarp();

  // the self column: z = x, one term per pair
  float part = 0.f;
  for (int j = lane; j < k; j += 32) {
    const float dxy = sd[j];
    const bool ow = x > si[j];
    part = __fadd_rn(part, __fmul_rn(KnnSupport<F>::eval(0.f, dxy, dxy, ow, p),
                                     sw[j]));
  }
  const float self = warp_sum(part);
  float* ox = out + x * static_cast<int64_t>(k + 1);
  if (lane == 0) ox[0] = self;

  // pass 2: the neighbor columns z = nbr_m, lane l taking m = l + 32t
  for (int m0 = 0; m0 < k; m0 += 32) {
    const int m = m0 + lane;
    if (m >= k) break;
    const float dxz = sd[m];
    float total = 0.f, acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float t = KnnSupport<F>::eval(
          dxz, gx[static_cast<int64_t>(j) * k + m], sd[j], x > si[j], p);
      acc = __fadd_rn(acc, __fmul_rn(t, sw[j]));
      if ((j & 31) == 31) {
        total = __fadd_rn(total, acc);
        acc = 0.f;
      }
    }
    ox[1 + m] = __fadd_rn(total, acc);
  }
}

struct KnnLaunch {
  const float* dn;
  const float* g;
  const int* idx;
  float* out;
  int64_t n;
  int k;
  Params p;
  cudaStream_t stream;

  template <class F>
  int operator()() const {
    const size_t smem = size_t(kWarps) * 3 * k * sizeof(float);
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    knn_values_kernel<F><<<blocks, kThreads, smem, stream>>>(dn, g, idx, out,
                                                             n, k, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// The sparse cohesion values out (n, k+1) float32 of the graph (dn (n, k)
// float32, g (n, k, k) float32, idx (n, k) int32, all row-major
// contiguous) for weight family `wid` with parameters p0, p1.  Needs n >= 1
// and 1 <= k <= 1024.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown family or a shape out of range).
extern "C" int pald_knn_values_f32(const float* dn, const float* g,
                                   const int* idx, float* out, int64_t n,
                                   int k, int wid, float p0, float p1,
                                   void* stream) {
  if (n < 1 || k < 1 || k > kMaxK ||
      (n + kWarps - 1) / kWarps > static_cast<int64_t>(0x7fffffff))
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_weight(
      wid, KnnLaunch{dn, g, idx, out, n, k, {p0, p1},
                     static_cast<cudaStream_t>(stream)});
}
