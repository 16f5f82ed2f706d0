// Weight functionals of PaLD as C++ functors, one per built-in family.
// A user-registered functional gets a functor of the same shape, generated
// from its traced callables (repro_torch/kernels/_functor.py) and compiled
// into libraries of its own (dispatch_weight's kUser).
//
// Counterpart of repro_torch/core/weights.py (and repro/core/weights.py):
// each functor repeats the torch/jnp expressions of its family for one
// (x, y, z) triple.  The kernels take the functor as a template argument,
// so every family compiles to its own specialized loop with no runtime
// branch on the family; the family's parameters (soft: 1/tau and 1/(4 tau),
// kernelized: 1/gamma^2) arrive as runtime floats.
//
// The strict families combine their comparisons with the non-short-circuit
// `&` and `|`: with `&&` / `||` nvcc predicated each comparison on the last
// and packed the 16 booleans of a thread's outputs into bit masks (seen in
// the SASS of the `ignore` cohesion loop).
//
// kHasShare: the family declares share(own, other), with support = share *
// focus on the same triple (soft); the k-NN kernel reuses its focus so.
//
// Predicated forms.  Drop, ignore and kernelized also give `add`, which
// adds the family's term under a predicate instead of multiplying W by a
// {0, 1} (or {0, share}) select: two compares and a predicated FADD per
// triple for the strict families, one compare and a predicated FFMA for
// kernelized.  On a finite w it is bitwise the multiply form (1 * w = w,
// fma(0, w, acc) = acc), so it sums the same terms in the same order; on an
// infinite or nan w the multiply form gives the reference's nan (0 * inf)
// and the predicate does not, so the kernels take `add` only when every W
// is finite (the wrappers check, kernels/pald_cohesion.py::add_form).
//
// Exactness.  The strict and split families are comparisons and selects,
// bitwise equal to the torch bodies.  The smooth families (soft,
// kernelized) spell every multiply and add with the _rn intrinsics, so nvcc
// cannot contract them into an FMA: each weight is then bitwise equal to
// the torch body too, and a kernel differs from its plain version only by
// the order in which the weights are summed.  clip() and nan_min() keep nan
// flowing, as jnp.clip / jnp.minimum do, so the inf - inf = nan guards on
// +inf padding fire as in the reference (fminf/fmaxf would swallow the nan).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace pald {

struct Params {
  float p0;  // soft: 1/tau; kernelized: 1/gamma^2
  float p1;  // soft: 1/(4 tau)
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // nan passes through
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// smoothstep sigmoid 0.5 + x*(0.5 - |x|/8) on clip(x, -2, 2)
__device__ __forceinline__ float sigmoid(float x) {
  x = clip(x, -2.f, 2.f);
  return __fadd_rn(0.5f,
                   __fmul_rn(x, __fsub_rn(0.5f, __fmul_rn(0.125f, fabsf(x)))));
}

// sigmoid(diff * inv) with the nan diff (inf - inf) pinned to tie
__device__ __forceinline__ float safe_unit(float diff, float inv, float tie) {
  const float s = sigmoid(__fmul_rn(diff, inv));
  return diff != diff ? tie : s;
}

// acc += w where own < other (kLe: own <= other, own wins the tie) and
// own < pair
template <bool kLe>
__device__ __forceinline__ void add_if_below(float& acc, float own,
                                             float other, float pair,
                                             float w) {
  if constexpr (kLe)
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.f32 p, %1, %2;\n\t"
        "setp.lt.and.f32 p, %1, %3, p;\n\t"
        "@p add.rn.f32 %0, %0, %4;\n\t}"
        : "+f"(acc)
        : "f"(own), "f"(other), "f"(pair), "f"(w));
  else
    asm("{\n\t.reg .pred p;\n\t"
        "setp.lt.f32 p, %1, %2;\n\t"
        "setp.lt.and.f32 p, %1, %3, p;\n\t"
        "@p add.rn.f32 %0, %0, %4;\n\t}"
        : "+f"(acc)
        : "f"(own), "f"(other), "f"(pair), "f"(w));
}

// acc = fma(s, w, acc) where own < pair
__device__ __forceinline__ void fma_if_below(float& acc, float own,
                                             float pair, float s, float w) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "@p fma.rn.f32 %0, %3, %4, %0;\n\t}"
      : "+f"(acc)
      : "f"(own), "f"(pair), "f"(s), "f"(w));
}

// (d_xz < d_xy) | (d_yz < d_xy); fminf returns the non-nan operand, which
// gives the same answer as the or of the two comparisons on any input
__device__ __forceinline__ float focus_strict(float dxz, float dyz, float dxy) {
  return fminf(dxz, dyz) < dxy ? 1.f : 0.f;
}

struct Drop {
  static constexpr bool kTiebreak = false;
  static constexpr bool kPredicated = true;
  static constexpr bool kHasShare = false;
  __device__ __forceinline__ static float focus(float a, float b, float t,
                                                const Params&) {
    return focus_strict(a, b, t);
  }
  __device__ __forceinline__ static float support(float own, float other,
                                                  float pair, bool,
                                                  const Params&) {
    return ((own < other) & (own < pair)) ? 1.f : 0.f;
  }
  template <bool>
  __device__ __forceinline__ static void add(float& acc, float own,
                                             float other, float pair,
                                             float w, const Params&) {
    add_if_below<false>(acc, own, other, pair, w);
  }
};

struct Split {
  static constexpr bool kTiebreak = false;
  static constexpr bool kPredicated = false;
  static constexpr bool kHasShare = false;
  // strict ? 1 : (eq ? 0.5 : 0); when neither operand is below t, one of
  // them equals t exactly when their minimum does
  __device__ __forceinline__ static float focus(float a, float b, float t,
                                                const Params&) {
    const float m = fminf(a, b);
    return m < t ? 1.f : (m == t ? 0.5f : 0.f);
  }
  __device__ __forceinline__ static float support(float own, float other,
                                                  float pair, bool,
                                                  const Params&) {
    const float share = own < other ? 1.f : (own == other ? 0.5f : 0.f);
    const float half = own < pair ? 1.f : (own == pair ? 0.5f : 0.f);
    return share * half;  // each in {0, 0.5, 1}: exact
  }
};

struct Ignore {
  static constexpr bool kTiebreak = true;
  static constexpr bool kPredicated = true;
  static constexpr bool kHasShare = false;
  __device__ __forceinline__ static float focus(float a, float b, float t,
                                                const Params&) {
    return focus_strict(a, b, t);
  }
  __device__ __forceinline__ static float support(float own, float other,
                                                  float pair, bool own_wins,
                                                  const Params&) {
    const bool wins = (own < other) | ((own == other) & own_wins);
    return (wins & (own < pair)) ? 1.f : 0.f;
  }
  // kLe: own wins every tie of the slab (one `<=` compare, not `<` or `==`)
  template <bool kLe>
  __device__ __forceinline__ static void add(float& acc, float own,
                                             float other, float pair,
                                             float w, const Params&) {
    add_if_below<kLe>(acc, own, other, pair, w);
  }
};

struct Soft {
  static constexpr bool kTiebreak = false;
  static constexpr bool kPredicated = false;
  static constexpr bool kHasShare = true;
  __device__ __forceinline__ static float focus(float a, float b, float t,
                                                const Params& p) {
    return safe_unit(__fsub_rn(t, nan_min(a, b)), p.p0, 0.f);
  }
  // clip(0.5 + (other - own) / (4 tau), 0, 1); support is share * focus
  // on any input where the product is not nan (the k-NN kernel's reuse)
  __device__ __forceinline__ static float share(float own, float other,
                                                const Params& p) {
    return clip(__fadd_rn(0.5f, __fmul_rn(__fsub_rn(other, own), p.p1)), 0.f,
                1.f);
  }
  __device__ __forceinline__ static float support(float own, float other,
                                                  float pair, bool,
                                                  const Params& p) {
    const float memb =
        sigmoid(__fmul_rn(__fsub_rn(pair, nan_min(own, other)), p.p0));
    const float share =
        clip(__fadd_rn(0.5f, __fmul_rn(__fsub_rn(other, own), p.p1)), 0.f, 1.f);
    const float res = __fmul_rn(share, memb);
    return res != res ? 0.f : res;
  }
};

struct Kernelized {
  static constexpr bool kTiebreak = false;
  static constexpr bool kPredicated = true;
  static constexpr bool kHasShare = false;
  __device__ __forceinline__ static float focus(float a, float b, float t,
                                                const Params&) {
    return focus_strict(a, b, t);
  }
  __device__ __forceinline__ static float support(float own, float other,
                                                  float pair, bool,
                                                  const Params& p) {
    const float share = safe_unit(
        __fsub_rn(__fmul_rn(other, other), __fmul_rn(own, own)), p.p0, 0.5f);
    return own < pair ? share : 0.f;
  }
  template <bool>
  __device__ __forceinline__ static void add(float& acc, float own,
                                             float other, float pair,
                                             float w, const Params& p) {
    const float share = safe_unit(
        __fsub_rn(__fmul_rn(other, other), __fmul_rn(own, own)), p.p0, 0.5f);
    fma_if_below(acc, own, pair, share, w);
  }
};

// kernel ids, as in repro_torch/core/weights.py; kUser: the functor that
// repro_torch/kernels/_functor.py generated from a user-registered
// functional
enum WeightId : int { kDrop = 0, kSplit = 1, kIgnore = 2, kSoft = 3,
                      kKernelized = 4, kUser = 5 };

// Call f.template operator()<Functor>() for the functor of id; returns
// cudaErrorInvalidValue for an unknown id.  A user library (a translation
// unit built with -include of the generated header and
// -DPALD_USER_WEIGHT=<its struct>, kernels/_build.py) instantiates the
// kernels for that functor alone, under kUser.
template <class Launch>
int dispatch_weight(int id, Launch&& f) {
#ifdef PALD_USER_WEIGHT
  return id == kUser ? f.template operator()<PALD_USER_WEIGHT>()
                     : static_cast<int>(cudaErrorInvalidValue);
#else
  switch (id) {
    case kDrop: return f.template operator()<Drop>();
    case kSplit: return f.template operator()<Split>();
    case kIgnore: return f.template operator()<Ignore>();
    case kSoft: return f.template operator()<Soft>();
    case kKernelized: return f.template operator()<Kernelized>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

}  // namespace pald
