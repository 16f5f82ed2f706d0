// Distances from feature rows, one template per metric.
//
// Counterpart of repro_torch/core/features.py (dist_tile, row_norms,
// masked_dist_tile).  The contract: on the same X these give bitwise the
// distances of repro_torch.core.features.cdist_reference, so every
// operation is the plain version's, in its order:
//
//   acc       = sum over k = 0..d-1, in order, of a_k * b_k
//               (manhattan: of |a_k - b_k|), one rounded multiply (or
//               difference) and one rounded add per feature, from 0
//   norm(a)   = the same sum of a_k * a_k; cosine: sqrt(max(., 1e-30))
//   sqeuclid  = max((na + nb) - 2 acc, 0)      (nan passes)
//   euclid    = sqrt(sqeuclid)
//   cosine    = 1 - acc / (na * nb)
//   manhattan = acc
//
// Every multiply, add, divide and square root is spelled with an _rn
// intrinsic (as pald_weights.cuh does), so nvcc cannot contract a multiply
// and an add into an FMA, which would round once where torch rounds twice.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace pald {

// metric ids, as in repro_torch/kernels/pald_fused.py
enum MetricId : int { kSqEuclidean = 0, kEuclidean = 1, kCosine = 2,
                      kManhattan = 3 };

constexpr float kNormEps = 1e-30f;  // cosine guard: zero rows get distance 1

template <int M>
struct Dist {
  // does the metric read the rows' norms?
  static constexpr bool kNorms = M != kManhattan;

  // one feature of the pair's running sum
  __device__ __forceinline__ static float step(float acc, float a, float b) {
    if constexpr (M == kManhattan)
      return __fadd_rn(acc, fabsf(__fsub_rn(a, b)));
    else
      return __fadd_rn(acc, __fmul_rn(a, b));
  }

  // a row's norm term from its sum of squares
  __device__ __forceinline__ static float norm(float sumsq) {
    if constexpr (M == kCosine)
      return __fsqrt_rn(sumsq < kNormEps ? kNormEps : sumsq);
    else
      return sumsq;
  }

  // the distance from the pair's sum and the two rows' norm terms
  __device__ __forceinline__ static float finish(float acc, float na,
                                                 float nb) {
    if constexpr (M == kManhattan) {
      return acc;
    } else if constexpr (M == kCosine) {
      return __fsub_rn(1.f, __fdiv_rn(acc, __fmul_rn(na, nb)));
    } else {
      float d2 = __fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, acc));
      d2 = d2 < 0.f ? 0.f : d2;  // nan passes, as torch.where's does
      if constexpr (M == kEuclidean) d2 = __fsqrt_rn(d2);
      return d2;
    }
  }
};

// the padding contract of masked_dist_tile at global indices (a, b):
// +inf past n_valid, exactly 0 on the diagonal
__device__ __forceinline__ float masked(float dist, int64_t a, int64_t b,
                                        int64_t n_valid) {
  if (a >= n_valid || b >= n_valid) dist = __int_as_float(0x7f800000);
  return a == b ? 0.f : dist;
}

// the rows' norm terms, one thread per row, features in order
template <int M>
__global__ void row_norms_kernel(const float* __restrict__ x,
                                 float* __restrict__ norms, int64_t n,
                                 int64_t d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= n) return;
  const float* row = x + r * d;
  float s = 0.f;
  for (int64_t k = 0; k < d; ++k)
    s = Dist<kSqEuclidean>::step(s, row[k], row[k]);
  norms[r] = Dist<M>::norm(s);
}

// Launch the norms pre-pass into the (n,) scratch `norms` (nothing for a
// metric without norms); returns cudaGetLastError().
template <int M>
int launch_row_norms(const float* x, float* norms, int64_t n, int64_t d,
                     cudaStream_t stream) {
  if constexpr (Dist<M>::kNorms) {
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    row_norms_kernel<M><<<blocks, 256, 0, stream>>>(x, norms, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Call f.template operator()<M>() for the metric id; cudaErrorInvalidValue
// for an unknown id.
template <class Launch>
int dispatch_metric(int id, Launch&& f) {
  switch (id) {
    case kSqEuclidean: return f.template operator()<kSqEuclidean>();
    case kEuclidean: return f.template operator()<kEuclidean>();
    case kCosine: return f.template operator()<kCosine>();
    case kManhattan: return f.template operator()<kManhattan>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pald
