// Streaming k-nearest-neighbor selection on Hopper, straight from feature
// vectors: for every row x of X (n, d), its k nearest OTHER rows, ascending
// by (distance, index).  Replaces the TPU kernel
// repro/kernels/pald_topk.py::topk_pallas.  D never exists in device
// memory: each block computes its distance tiles from the feature rows and
// folds them into per-row best-lists in shared memory.
//
// What bounds it on the H100: operations.  Every one of the n^2 pairs needs
// its distance (d rounded multiplies and d rounded adds, no FMA, plus the
// metric's finish: pald_dist.cuh) and at least one compare against its
// row's current k-th best; the data are X (n d floats) and the (n, k)
// outputs.  At n = 50,000, d = 8 that is ~5e10 lane instructions against
// ~3 MB of memory traffic.
//
// Design.  A block of 256 threads owns R rows (R = 64 for k <= 128, 32 for
// k <= 512, 16 for k <= 1024) and streams all n candidates through shared
// memory in chunks of 64:
//   1. thread (ty, tx) = (tid / 16, tid % 16) sums rows ty*R/16.. against
//      candidates 4tx..4tx+3 in registers, the features staged 16 at a
//      time (transposed, so any d fits), and finishes each pair with the
//      rows' norms (an (n,) pre-pass);
//   2. it compares its 16 pairs with their rows' current k-th best (per-row
//      thresholds in shared memory); only a thread holding a pair at or
//      below one looks closer, and appends each pair that beats its row's
//      k-th best to the row's queue (a shared counter per row);
//   3. if anything was queued (the barrier's __syncthreads_or says), warp
//      w drains the queues of rows w*R/8..: each queued candidate that
//      still beats the k-th best is inserted into the row's sorted
//      best-list, and the row's threshold is updated.  For k <= 32 the
//      lists live in registers, entry l of each of the warp's rows in lane
//      l (position by a ballot, shift by one shuffle); past 32 in shared
//      memory (position by a warp-wide count, entries after it shifted
//      down by one, the last dropped).
// Queuing is rare after the first chunks (about k ln(n/k) insertions a row
// on random order), so steps 1-2 dominate.  For euclidean the pairs are
// finished as squared distances, and the correctly rounded root is taken
// only for pairs at or below the row's bound B = (next float above the
// k-th best)^2,
// rounded up: a larger square has a root above that float, so it cannot
// enter the list, and the root of every pair that can is the plain
// version's.

// Contract (the plain version is kernels/pald_topk.py::topk_select_torch):
//   - every distance is pald_dist.cuh's, bitwise cdist_reference's;
//   - candidates compare on the composite key (value, index), a total order
//     over real candidates, so the lists are exactly the first k of the
//     stable sort whatever order the chunks arrive in or how rows are
//     split between blocks;
//   - self is never a candidate and indices >= n are never read, so they
//     lose to every real candidate (the lists start as (+inf, INT32_MAX)
//     sentinels, which any real candidate beats);
//   - k <= kMaxK = 1024; the wrapper raises beyond it.
// Distances are assumed not nan (finite features give none).  64-bit
// offsets throughout.
#include <cstdint>

#include "pald_dist.cuh"

namespace {

using pald::Dist;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCand = 64;       // candidates per chunk
constexpr int kChunk = 16;      // features staged per step
constexpr int kMaxK = 1024;
constexpr int kSentinel = 0x7fffffff;

// composite strict less-than on (value, index): the stable order
__device__ __forceinline__ bool key_less(float v1, int i1, float v2, int i2) {
  return (v1 < v2) | ((v1 == v2) & (i1 < i2));
}

// shared-memory layout of a block with R rows and lists of k entries:
// staged row and candidate features, the per-row queues of one chunk, the
// per-row thresholds and queue counts, the best-lists
template <int R>
struct Layout {
  static constexpr int kLdA = R + 1;      // staged row features (padded)
  static constexpr int kLdB = kCand + 4;  // staged candidate features
  static constexpr size_t fb = sizeof(float) * kChunk * kLdA;
  static constexpr size_t queue = fb + sizeof(float) * kChunk * kLdB;
  static constexpr size_t rows = queue + size_t(R) * kCand * 8;
  static constexpr size_t lists = rows + size_t(R) * 16;
  // the lists live in shared memory only past 32 entries
  static size_t bytes(int k) {
    return lists + (k <= 32 ? 0 : size_t(R) * k * 8);
  }
};

// The largest squared distance whose correctly rounded root can still be
// <= tv, rounded up: (next float above tv)^2.
__device__ __forceinline__ float root_bound(float tv) {
  const float u = nextafterf(tv, __int_as_float(0x7f800000));
  return __fmul_ru(u, u);
}

// One warp inserts (v, i) into the sorted list lv/li of k entries: the
// entries from its position on move down by one, the last is dropped.
// tv, ti become the new k-th entry, in every lane.
__device__ __forceinline__ void insert(float* lv, int* li, int k, float v,
                                       int i, int lane, float& tv, int& ti) {
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += key_less(lv[e], li[e], v, i);
  const int p = __reduce_add_sync(0xffffffffu, cnt);
  for (int top = k - 1; top > p; top -= 32) {
    const int e = top - lane;
    float sv = 0.f;
    int si = 0;
    const bool act = e > p;
    if (act) {
      sv = lv[e - 1];
      si = li[e - 1];
    }
    __syncwarp();
    if (act) {
      lv[e] = sv;
      li[e] = si;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = v;
    li[p] = i;
  }
  __syncwarp();
  tv = lv[k - 1];
  ti = li[k - 1];
}

// The same for a list of k <= 32 entries held in registers, entry l in
// lane l: the position is a ballot, the shift one shuffle.
__device__ __forceinline__ void insert_reg(float& lv, int& li, int k, float v,
                                           int i, int lane, float& tv,
                                           int& ti) {
  const int p = __popc(__ballot_sync(0xffffffffu, key_less(lv, li, v, i)));
  const float uv = __shfl_up_sync(0xffffffffu, lv, 1);
  const int ui = __shfl_up_sync(0xffffffffu, li, 1);
  if (lane > p) {
    lv = uv;
    li = ui;
  } else if (lane == p) {
    lv = v;
    li = i;
  }
  tv = __shfl_sync(0xffffffffu, lv, k - 1);
  ti = __shfl_sync(0xffffffffu, li, k - 1);
}

// kRegs: k <= 32, each warp keeps its rows' lists in registers
template <int M, int R, bool kRegs>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, const float* __restrict__ norms,
            float* __restrict__ out_v, int* __restrict__ out_i, int64_t n,
            int64_t d, int k) {
  constexpr int TR = R / 16;       // rows per thread in the tile
  constexpr int RW = R / kWarps;   // rows per warp in the drain
  // euclidean: squared distances, the root taken for the survivors only
  constexpr bool kLazyRoot = M == pald::kEuclidean;
  constexpr int MT = kLazyRoot ? static_cast<int>(pald::kSqEuclidean) : M;
  using L = Layout<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  float (*fa)[L::kLdA] = reinterpret_cast<float (*)[L::kLdA]>(smem);
  float (*fb)[L::kLdB] = reinterpret_cast<float (*)[L::kLdB]>(smem + L::fb);
  float (*qv)[kCand] = reinterpret_cast<float (*)[kCand]>(smem + L::queue);
  int (*qi)[kCand] = reinterpret_cast<int (*)[kCand]>(qv + R);
  float* tv = reinterpret_cast<float*>(smem + L::rows);  // k-th best value
  int* ti = reinterpret_cast<int*>(tv + R);              // and its index
  float* tb = reinterpret_cast<float*>(ti + R);          // root_bound(tv)
  int* qn = reinterpret_cast<int*>(tb + R);              // queue lengths
  float* lv_all = reinterpret_cast<float*>(smem + L::lists);  // !kRegs
  int* li_all = reinterpret_cast<int*>(lv_all + R * k);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const float inf = __int_as_float(0x7f800000);

  float rv[kRegs ? RW : 1];  // kRegs: entry `lane` of the warp's rows' lists
  int ri[kRegs ? RW : 1];
#pragma unroll
  for (int q = 0; q < (kRegs ? RW : 1); ++q) {
    rv[q] = inf;
    ri[q] = kSentinel;
  }
  if constexpr (!kRegs) {
    for (int e = tid; e < R * k; e += kThreads) {
      lv_all[e] = inf;
      li_all[e] = kSentinel;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    tv[r] = inf;
    ti[r] = kSentinel;
    tb[r] = inf;
    qn[r] = 0;
  }
  float nr[TR];  // the thread's rows' norms
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int64_t row = r0 + ty * TR + a;
    nr[a] = (Dist<M>::kNorms && row < n) ? norms[row] : 0.f;
  }

  // the rows' features of feature chunk k0 into fa (neighbouring threads
  // read neighbouring features of a row)
  auto stage_rows = [&](int64_t k0, int kc) {
    for (int e = tid; e < kChunk * R; e += kThreads) {
      const int r = e / kChunk, f = e % kChunk;
      const int64_t row = r0 + r;
      fa[f][r] = (row < n && f < kc) ? x[row * d + k0 + f] : 0.f;
    }
  };
  // with d <= 16 the rows' features are staged once for all chunks
  const bool rows_once = d <= kChunk;
  if (rows_once) stage_rows(0, static_cast<int>(d));

  for (int64_t c0 = 0; c0 < n; c0 += kCand) {
    // 1. the pair sums of the R x 64 tile (at least one pass, so the
    // barriers below run even for d = 0)
    float acc[TR][4] = {};
    int64_t k0 = 0;
    do {
      const int kc = static_cast<int>(d - k0 < kChunk ? d - k0 : kChunk);
      if (!rows_once) stage_rows(k0, kc);
      for (int e = tid; e < kChunk * kCand; e += kThreads) {
        const int c = e / kChunk, f = e % kChunk;
        const int64_t col = c0 + c;
        fb[f][c] = (col < n && f < kc) ? x[col * d + k0 + f] : 0.f;
      }
      __syncthreads();
      for (int f = 0; f < kc; ++f) {
        const float4 b = *reinterpret_cast<const float4*>(&fb[f][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float av = fa[f][ty * TR + a];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[a][j] = Dist<M>::step(acc[a][j], av, bv[j]);
        }
      }
      __syncthreads();
      k0 += kChunk;
    } while (k0 < d);

    // 2. finish each pair in place, and queue the ones that beat their
    // row's k-th best (a threshold of the last drain: only ever looser).
    // A pair above its row's bound (k-th best, or for euclidean B) cannot
    // beat it: only a thread holding one at or below it looks closer.
    float nc[4];  // the candidates' norms
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = c0 + tx * 4 + j;
      nc[j] = (Dist<M>::kNorms && col < n) ? norms[col] : 0.f;
    }
    bool any = false;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int lr = ty * TR + a;
      const float bound = kLazyRoot ? tb[lr] : tv[lr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[a][j] = Dist<MT>::finish(acc[a][j], nr[a], nc[j]);
        any |= acc[a][j] <= bound;
      }
    }
    bool queued = false;
    if (any) {
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const int lr = ty * TR + a;
        const int64_t row = r0 + lr;
        const float tva = tv[lr], tba = tb[lr];
        const int tia = ti[lr];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t col = c0 + tx * 4 + j;
          if (row >= n || col >= n || col == row) continue;
          float v = acc[a][j];
          bool keep;
          if constexpr (kLazyRoot) {
            keep = v <= tba;
            if (keep) {
              v = __fsqrt_rn(v);
              keep = key_less(v, static_cast<int>(col), tva, tia);
            }
          } else {
            keep = key_less(v, static_cast<int>(col), tva, tia);
          }
          if (keep) {
            const int p = atomicAdd(&qn[lr], 1);
            qv[lr][p] = v;
            qi[lr][p] = static_cast<int>(col);
            queued = true;
          }
        }
      }
    }
    // the barrier also tells the block whether anything was queued
    if (!__syncthreads_or(queued)) continue;

    // 3. each warp drains its rows' queues into their lists
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int lr = warp * RW + q;
      const int cnt = qn[lr];  // uniform across the warp
      if (cnt == 0) continue;
      float tvq = tv[lr];
      int tiq = ti[lr];
      for (int base = 0; base < cnt; base += 32) {
        const int e = base + lane;
        float v = inf;
        int i = kSentinel;
        if (e < cnt) {
          v = qv[lr][e];
          i = qi[lr][e];
        }
        unsigned mask = __ballot_sync(0xffffffffu, key_less(v, i, tvq, tiq));
        while (mask) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cv = __shfl_sync(0xffffffffu, v, b);
          const int ci = __shfl_sync(0xffffffffu, i, b);
          if (!key_less(cv, ci, tvq, tiq)) continue;
          if constexpr (kRegs)
            insert_reg(rv[q], ri[q], k, cv, ci, lane, tvq, tiq);
          else
            insert(lv_all + lr * k, li_all + lr * k, k, cv, ci, lane, tvq,
                   tiq);
        }
      }
      __syncwarp();
      if (lane == 0) {
        tv[lr] = tvq;
        ti[lr] = tiq;
        tb[lr] = root_bound(tvq);
        qn[lr] = 0;
      }
    }
    // the next chunk's first barrier orders these writes before its reads
  }
  if constexpr (kRegs) {
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int64_t row = r0 + warp * RW + q;
      if (row < n && lane < k) {
        out_v[row * k + lane] = rv[q];
        out_i[row * k + lane] = ri[q];
      }
    }
  } else {
    __syncthreads();
    for (int e = tid; e < R * k; e += kThreads) {
      const int64_t row = r0 + e / k;
      if (row < n) {
        out_v[row * k + e % k] = lv_all[e];
        out_i[row * k + e % k] = li_all[e];
      }
    }
  }
}

template <int M, int R, bool kRegs>
int launch_rows(const float* x, const float* norms, float* out_v, int* out_i,
                int64_t n, int64_t d, int k, cudaStream_t stream) {
  const size_t smem = Layout<R>::bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<M, R, kRegs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + R - 1) / R);
  topk_kernel<M, R, kRegs><<<blocks, kThreads, smem, stream>>>(
      x, norms, out_v, out_i, n, d, k);
  return static_cast<int>(cudaGetLastError());
}

struct TopkPerMetric {
  const float* x;
  float* norms;
  float* out_v;
  int* out_i;
  int64_t n, d;
  int k;
  cudaStream_t stream;

  template <int M>
  int operator()() const {
    const int status = pald::launch_row_norms<M>(x, norms, n, d, stream);
    if (status != 0) return status;
    if (k <= 32)
      return launch_rows<M, 64, true>(x, norms, out_v, out_i, n, d, k, stream);
    if (k <= 128)
      return launch_rows<M, 64, false>(x, norms, out_v, out_i, n, d, k,
                                       stream);
    if (k <= 512)
      return launch_rows<M, 32, false>(x, norms, out_v, out_i, n, d, k,
                                       stream);
    return launch_rows<M, 16, false>(x, norms, out_v, out_i, n, d, k, stream);
  }
};

}  // namespace

// The k nearest other rows of each row of the row-major contiguous float32
// X (n, d) for `metric` (0 sqeuclidean, 1 euclidean, 2 cosine, 3
// manhattan): distances into out_v (n, k) float32 and indices into out_i
// (n, k) int32, each row ascending by (distance, index).  `norms` is an
// (n,) float32 scratch buffer.  Needs 1 <= k <= min(n - 1, 1024) and
// n < 2^31.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown metric or a shape out of range).
extern "C" int pald_topk_f32(const float* x, float* norms, float* out_v,
                             int* out_i, int64_t n, int64_t d, int k,
                             int metric, void* stream) {
  if (n < 2 || d < 0 || k < 1 || k > kMaxK || k > n - 1 ||
      n > static_cast<int64_t>(kSentinel))
    return static_cast<int>(cudaErrorInvalidValue);
  return pald::dispatch_metric(
      metric, TopkPerMetric{x, norms, out_v, out_i, n, d, k,
                            static_cast<cudaStream_t>(stream)});
}
