// Streaming k-nearest-neighbor selection on Hopper, straight from feature
// vectors, behind the entry points of pald_topk.cu (one item, and the
// block entry) and pald_topk_chunk.cu (a chunk of items): for every row x of X (n, d), its k nearest OTHER rows, ascending
// by (distance, index).  Replaces the TPU kernel
// repro/kernels/pald_topk.py::topk_pallas.  D never exists in device
// memory: each block computes its distance tiles from the feature rows and
// folds them into per-row best-lists.
//
// What bounds it on the H100: operations.  Every one of the n^2 pairs needs
// its distance (d rounded multiplies and d rounded adds, no FMA, plus the
// metric's finish: pald_dist.cuh) and at least one compare against its
// row's current k-th best; the data are X (n d floats) and the (n, k)
// outputs.  At n = 50,000, d = 8 that is ~5e10 lane instructions against
// ~3 MB of memory traffic.
//
// Design.  A block of 8 warps owns R = 8 TR rows (TR = 4 for k <= 32, 8
// for k <= 128, 4 for k <= 256, 2 past 256), warp w the TR rows
// w TR.., and streams all n candidates through shared memory in chunks
// of 128:
//   - grid ceil(n / R): at n = 50,000 and k <= 32, 1563 blocks for 528
//     slots (four blocks an SM).  Splitting the candidates between blocks
//     (a grid (ceil(n / R), S) and a merge of the S lists) was slower at
//     every n measured, 8192 included, where the grid is below one wave:
//     each segment refills its lists from scratch;
//   - staging: a ring of kStages slots, each a chunk's features ([128][p]
//     floats, p a multiple of 4 with an odd count of 16-byte pieces, so
//     the float4 reads of 8 consecutive candidates hit 32 distinct banks)
//     and their norms, filled by 16-byte cp.async pieces (4-byte ones when
//     d % 4 != 0 or X is not 16-byte aligned).  A block waits at one
//     barrier per slot: the copies of slot t+1 run under the loop of slot
//     t.  Past d = 64 a chunk takes one slot per 64 features, and the rows
//     ride in each slot; up to 64 they are staged once.  The chunks come
//     in turn from the one that holds the block's own rows;
//   - lane l of warp w sums its TR rows against candidates l, l+32, l+64,
//     l+96 (TR x 4 sums in registers; a row's float4 is a broadcast, a
//     candidate's a conflict-free read), then finishes each pair with the
//     rows' and candidates' norms (an (n,) pre-pass);
//   - the warp compares each row's least pair with the row's bound (its
//     k-th best; for euclidean the square of the next float above it),
//     and only for a row where some lane holds a pair at or below it does
//     it ballot the pairs that beat the k-th best, a ballot (32
//     candidates) at a time.  For k <= 32 a row's list sits in registers
//     while its warp works on it (entry l in lane l; between chunks in
//     shared memory, so the sums keep the registers: 4 blocks an SM), and
//     each candidate is inserted in turn (position by a ballot, shift by
//     one shuffle).  Past 32 the lists sit in shared memory: the row's
//     passing candidates of the chunk (up to 128) are gathered, sorted by
//     rank and merged into the list in one pass (merge_batch: every
//     entry's new place by a binary search in the other sequence).
// Past k = kLargeK = 1024 (topk_large_kernel, the large-k variant;
// replaces topk_pallas at those k as well) no layout of lists fits the
// 227 KB of shared memory (8 B k a row: 16 rows a block pass it from k =
// 1067 past 64 features), and a list merged where it lies in device memory
// moves up to k entries a merge, ~n/128 merges a row.  So the variant
// selects by threshold, with traffic that does not grow with the number of
// chunks:
//   - each row's candidates are keyed by the finished distance's float
//     bits (order_key: -0 as +0, a total order on the values), and up to
//     three sweeps over the candidates build per-row histograms of the
//     key's digits (bits 31-21, 20-10, 9-0; 2048 bins a row in shared
//     memory, integer counts, exact in any order), each narrowing the
//     range that holds the k-th value; a row whose chosen bin holds just
//     the candidates it still needs is done, and a sweep that no row of
//     the block needs is skipped.  In the first sweep the warp lowers a
//     cut past the bins that already lie above k counted candidates, so
//     only candidates at or below the running k-th bin are counted;
//   - for euclidean the sweeps bin the correctly rounded root (two squares
//     can round to one root), taken only for pairs whose square is at or
//     below root_bound of the range's top; every other pair is skipped on
//     its square, so roots stay about as rare as in the k <= 1024 lists;
//   - a last sweep in ascending candidate order writes every candidate
//     below the k-th value T into the row's output slice (in arrival
//     order), and the ties at T in ascending index order, the first
//     `need` of them only, after them: ties are bounded by the count the
//     histograms left, however many duplicates share T, and the lowest
//     indices win, as the stable order wants;
//   - one bitonic sort (the all-ascending network with a mirrored first
//     step, so a count that is not a power of two needs no padding: the
//     reference's sort_pairs / merge_pairs,
//     src/repro/kernels/pald_topk.py:107-135) orders the entries below T
//     by (value, index), in shared memory up to kSortCap entries and in
//     the output slice itself past that.
// Every sweep runs a copy of the staged distance loop of k <= 1024 (the
// same ring, sums and finish; the note above its `sweep` says why a
// copy), so the variant costs about four of its sweeps and a
// sort; shared memory holds the ring and the histograms and does not grow
// with k.  What bounds it: operations, the n^2 pair sums of each sweep.
// Rows, their thresholds, lists and batches belong to one warp, so the
// insertions need no block barrier.  Insertions are rare after the first
// chunks (about k ln(n/k) a row on random order), so at small k the sums
// dominate.  For euclidean the pairs are finished as squared distances,
// and the correctly rounded root is taken only for pairs at or below the
// row's bound B = (next float above the k-th best)^2, rounded up: a larger
// square has a root above that float, so it cannot enter the list, and the
// root of every pair that can is the plain version's.

// The block entry (pald_topk_block_f32) runs the same kernel over rows
// [0, m) of one matrix against the w candidates of another, each with the
// global index of its first row: self is excluded by global index, and the
// lists hold global indices, (+inf, INT32_MAX) past the real candidates.
// A shard of a distributed run scores its rows against the candidate
// blocks it holds this way (repro_torch/core/distributed_knn.py) and
// merges the partial lists on the same (value, index) key, so its graph is
// bitwise the full call's: a distance depends only on its two rows.
//
// A chunk of items (the engine's batch= chunks, the reference's vmap): the
// full entry takes `items` X (n, d), one after another, and blockIdx.y is
// the item: X, the norms and the (n, k) outputs advance by one item's
// extent, and the indices stay each item's own 0..n-1.  Each item's blocks
// run exactly what a one-item grid's do, so a chunk's graph is bitwise its
// items' one at a time.  The norms pre-pass runs once over the chunk's b n
// rows, so an item's norms are 16-byte aligned only when n is a multiple
// of 4: the block stages them in 4-byte pieces otherwise (the same bits).
// Only the kChunk variant, which pald_topk_chunk.cu alone instantiates,
// takes the item: its offsets cost registers, and at k <= 32 the kernel
// sits at its 64-register cap, so one item runs code without them (and
// nvcc builds the two halves in parallel).
// A grid holds up to 65535 items (gridDim.y); past that the host issues
// one grid per 65535.  The block entry takes one item.
//
// Contract (the plain version is kernels/pald_topk.py::topk_select_torch):
//   - every distance is pald_dist.cuh's, bitwise cdist_reference's;
//   - candidates compare on the composite key (value, index), a total order
//     over real candidates, so the lists are exactly the first k of the
//     stable sort whatever order the chunks arrive in or how rows are
//     split between blocks;
//   - self is never a candidate and indices >= n are never read, so they
//     lose to every real candidate (the lists start as (+inf, INT32_MAX)
//     sentinels, which any real candidate beats);
//   - 1 <= k <= n - 1 (the block entry: any k >= 1, sentinels past the w
//     real candidates); the lists in shared memory up to k = kLargeK,
//     selected by threshold past it.
// Distances are assumed not nan (finite features give none).  64-bit
// offsets throughout (n k passes 2^31 at n = 10^6, k = 2148); no atomics.
#pragma once

#include <cstdint>

#include "pald_dist.cuh"
#include "pald_tile.cuh"

namespace pald::topk {

using pald::cp_async16;
using pald::cp_async4;
using pald::cp_async_commit;
using pald::cp_async_wait;
using pald::Dist;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCand = 128;     // candidates per chunk, 4 a lane
constexpr int kStages = 2;     // slots in the staging ring
constexpr int kMaxFeat = 64;   // features per slot
constexpr int kLargeK = 1024;  // past it the lists live in the outputs
constexpr int kSentinel = 0x7fffffff;
constexpr int64_t kMaxItems = 65535;  // items of one grid (gridDim.y)

// composite strict less-than on (value, index): the stable order
__device__ __forceinline__ bool key_less(float v1, int i1, float v2, int i2) {
  return (v1 < v2) | ((v1 == v2) & (i1 < i2));
}

// floats of a staged row of f features: a multiple of 4 holding an odd
// number of 16-byte pieces
__host__ __device__ constexpr int stage_pitch(int f) {
  return ((f + 3) / 4) % 2 ? (f + 3) / 4 * 4 : (f + 3) / 4 * 4 + 4;
}

// The shared-memory layout of a block of R rows at (d, k), in floats:
// the rows staged once (d <= kMaxFeat), the ring, the rows' thresholds and
// norms, and their lists: for k <= 32 where each lane keeps its entry
// between chunks (32 a row), past 32 the lists and each warp's batch (two
// of kCand entries: as found, and sorted).  The large-k variant's:
// large_bytes.
struct Layout {
  int kd;         // features per slot
  int parts;      // slots per chunk of candidates
  int pitch;      // floats per staged row
  int rows;       // floats of the rows staged once (0 past kMaxFeat)
  int slot;       // floats per slot: candidates, their norms, rows
  __host__ __device__ Layout(int64_t d, int R) {
    kd = static_cast<int>(d < kMaxFeat ? d : kMaxFeat);
    parts = d <= kMaxFeat ? 1 : static_cast<int>((d + kMaxFeat - 1) / kMaxFeat);
    pitch = stage_pitch(kd);
    rows = parts == 1 ? R * pitch : 0;
    slot = kCand * pitch + kCand + (parts == 1 ? 0 : R * pitch);
  }
  __host__ __device__ size_t bytes(int R, int k) const {
    const size_t batches = size_t(kWarps) * kCand * 16;
    return sizeof(float) * (size_t(rows) + size_t(kStages) * slot + 4 * R) +
           (k <= 32 ? size_t(R) * 32 * 8 : size_t(R) * k * 8 + batches);
  }
};

// TR, the rows of each warp at k (a block holds kWarps * TR rows): four
// with the lists in registers (k <= 32) at four blocks an SM, past that
// as many as two blocks an SM hold in shared memory
constexpr int warp_rows(int k) {
  return k <= 32 ? 4 : k <= 128 ? 8 : k <= 256 ? 4 : 2;
}

// the large-k variant: rows a warp, bins of a row's histogram (a digit of
// 11 bits), and the entries a block sorts in shared memory (the
// histograms' bytes, free by then)
constexpr int kLargeRows = 2;
constexpr int kLargeR = kWarps * kLargeRows;
constexpr int kBins = 2048;
constexpr int kSortCap = kLargeR * kBins / 2;

// its shared memory at width d, in bytes: the rows staged once, the ring,
// the rows' norms and sorted counts, then the R histograms
__host__ __device__ inline size_t large_bytes(int64_t d) {
  const Layout L(d, kLargeR);
  return sizeof(float) * (size_t(L.rows) + size_t(kStages) * L.slot +
                          2 * kLargeR) +
         sizeof(unsigned) * size_t(kLargeR) * kBins;
}

// The largest squared distance whose correctly rounded root can still be
// <= tv, rounded up: (next float above tv)^2.
__device__ __forceinline__ float root_bound(float tv) {
  const float u = nextafterf(tv, __int_as_float(0x7f800000));
  return __fmul_ru(u, u);
}

// lower_bound on the composite key: how many of the n sorted entries
// (lv, li) lie below (v, i)
__device__ __forceinline__ int count_below(const float* lv, const int* li,
                                           int n, float v, int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (key_less(lv[mid], li[mid], v, i))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One warp merges its batch of cnt candidates (bv, bi: distinct, each
// below the list's k-th entry) into the sorted list lv/li of k entries in
// one pass: the batch sorted by rank into sv/si, each batch entry placed
// at its rank plus the list entries below it, each list entry from the
// first place that changes moved down by the batch entries below it
// (tail first, so nothing is overwritten before it is read), the last
// ones dropped.  tv, ti become the new k-th entry, in every lane.
__device__ __forceinline__ void merge_batch(float* lv, int* li, int k,
                                            const float* bv, const int* bi,
                                            float* sv, int* si, int cnt,
                                            int lane, float& tv, int& ti) {
  for (int e = lane; e < cnt; e += 32) {
    const float v = bv[e];
    const int i = bi[e];
    int r = 0;
    for (int o = 0; o < cnt; ++o) r += key_less(bv[o], bi[o], v, i);
    sv[r] = v;
    si[r] = i;
  }
  __syncwarp();
  int place[kCand / 32];
#pragma unroll
  for (int t = 0; t < kCand / 32; ++t) {
    const int e = lane + 32 * t;
    place[t] = e < cnt ? e + count_below(lv, li, k, sv[e], si[e]) : k;
  }
  const int first = __shfl_sync(0xffffffffu, place[0], 0);
  for (int top = k - 1; top >= first; top -= 32) {
    const int e = top - lane;
    float v = 0.f;
    int i = 0, dst = k;
    if (e >= first) {
      v = lv[e];
      i = li[e];
      dst = e + count_below(sv, si, cnt, v, i);
    }
    __syncwarp();
    if (dst < k) {
      lv[dst] = v;
      li[dst] = i;
    }
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < kCand / 32; ++t) {
    const int e = lane + 32 * t;
    if (place[t] < k) {
      lv[place[t]] = sv[e];
      li[place[t]] = si[e];
    }
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

// A thread's share of the pieces of a staged row block: pp pieces a row
// (16-byte ones when vec, else 4-byte), pieces tid, tid + kThreads, ...
// walked without a division: (r, q) the first, (dr, dq) the step.
struct Pieces {
  int pp, r, q, dr, dq;
  __device__ Pieces(int nf, bool vec, int tid) {
    pp = vec ? nf / 4 : nf;
    const int p = pp > 0 ? pp : 1;
    r = pp > 0 ? tid / p : 1 << 30;
    q = tid - (tid / p) * p;
    dr = kThreads / p;
    dq = kThreads - dr * p;
  }
};

// Copy rows [base, base + count) of X, features [f0, f0 + nf) (nf as in
// P), into dst ([count][pitch]); rows at or past `limit` are left as they
// are.
__device__ __forceinline__ void stage_rows(float* dst, const float* x,
                                           int64_t base, int count,
                                           int64_t limit, int64_t d, int f0,
                                           int pitch, bool vec,
                                           const Pieces& P) {
  int r = P.r, q = P.q;
  while (r < count) {
    const int64_t row = base + r;
    if (row < limit) {
      if (vec)  // d % 4 == 0, X 16-byte aligned
        cp_async16(dst + r * pitch + 4 * q, x + row * d + f0 + 4 * q);
      else
        cp_async4(dst + r * pitch + q, x + row * d + f0 + q);
    }
    r += P.dr;
    q += P.dq;
    if (q >= P.pp) {
      q -= P.pp;
      ++r;
    }
  }
}

// kRegs: k <= 32, each warp keeps its rows' lists in registers.
// Rows [0, m) of xr (global index rg0 + row) against the w candidates of
// xc (global index cg0 + col); nr, nc their norm terms.  The full call
// passes X as both, n as m and w, and 0 as both offsets.
template <int M, int TR, bool kRegs, bool kChunk>
__global__ void __launch_bounds__(kThreads, kRegs ? 4 : 2)
topk_kernel(const float* __restrict__ xr, const float* __restrict__ xc,
            const float* __restrict__ nr, const float* __restrict__ nc,
            float* __restrict__ out_v, int* __restrict__ out_i, int64_t m,
            int64_t w, int64_t rg0, int64_t cg0, int64_t d, int k,
            bool vec) {
  constexpr int R = kWarps * TR;
  // euclidean: squared distances, the root taken for the survivors only
  constexpr bool kLazyRoot = M == pald::kEuclidean;
  constexpr bool kSquares = M == pald::kSqEuclidean || kLazyRoot;
  extern __shared__ __align__(16) float smem[];
  const Layout L(d, R);
  float* srows = smem;                       // [R][pitch], d <= kMaxFeat
  float* ring = smem + L.rows;               // kStages slots
  float* tv = ring + kStages * L.slot;       // k-th best value
  int* ti = reinterpret_cast<int*>(tv + R);  // and its index
  float* tb = reinterpret_cast<float*>(ti + R);  // euclidean: root_bound(tv)
  float* tn = tb + R;                        // the rows' norms
  float* lv_all = tn + R;                    // the lists (kRegs: homes)
  int* li_all = reinterpret_cast<int*>(lv_all + R * (kRegs ? 32 : k));

  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.y;
    xr += item * m * d;
    xc += item * w * d;
    nr += item * m;
    nc += item * w;
    out_v += item * m * k;
    out_i += item * m * k;
  }
  // an item's norms start w floats past the previous item's: 16-byte
  // pieces only where they stay aligned (one item's scratch always is)
  const bool nvec = !kChunk || reinterpret_cast<uintptr_t>(nc) % 16 == 0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* bv = reinterpret_cast<float*>(li_all + R * (kRegs ? 32 : k)) +
              warp * kCand * 4;                  // !kRegs: the batch
  int* bi = reinterpret_cast<int*>(bv + kCand);
  float* sv = bv + 2 * kCand;                    // and sorted
  int* sidx = reinterpret_cast<int*>(bv + 3 * kCand);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int chunks = static_cast<int>((w + kCand - 1) / kCand);
  const int slots = chunks * L.parts;
  // the chunks in turn from the one holding the block's first row (the
  // first chunk when the candidates do not hold it): in data whose near
  // neighbors lie near in index, the lists fill with near candidates first
  // and the later chunks insert little.  The lists do not depend on the
  // order.
  const int64_t own = rg0 + r0 - cg0;
  const int first = own >= 0 && own < w ? static_cast<int>(own / kCand) : 0;
  const float inf = __int_as_float(0x7f800000);

  // the warp's rows: thresholds, norms, lists (a list of k <= 32 lives
  // in registers while the warp works on its row, in shared memory
  // between chunks)
  const int lk = kRegs ? 32 : k;
  for (int e = lane; e < TR * lk; e += 32) {
    lv_all[warp * TR * lk + e] = inf;
    li_all[warp * TR * lk + e] = kSentinel;
  }
  if (lane < TR) {  // a row past m: a bound no pair meets
    const int64_t row = r0 + warp * TR + lane;
    const bool live = row < m;
    tv[warp * TR + lane] = live ? inf : -inf;
    ti[warp * TR + lane] = kSentinel;
    tb[warp * TR + lane] = live ? inf : -inf;
    tn[warp * TR + lane] = (Dist<M>::kNorms && live) ? nr[row] : 0.f;
  }
  __syncwarp();

  // (topk_large_kernel's `sweep` holds a copy of what follows, through the
  // finish of a chunk's pairs: the two stay in step)
  // slot t: chunk t / parts (counted from the block's own chunk), features
  // (t % parts) * kMaxFeat..; the last part of a chunk also brings the
  // candidates' norms
  auto locate = [&](int t, int& fp, int64_t& c0) {
    int ci = t;
    fp = 0;
    if (L.parts > 1) {
      ci = t / L.parts;
      fp = t - ci * L.parts;
    }
    ci += first;
    if (ci >= chunks) ci -= chunks;
    c0 = static_cast<int64_t>(ci) * kCand;
  };
  const int last_nf = static_cast<int>(d - int64_t(L.parts - 1) * kMaxFeat);
  const Pieces full(L.kd, vec, tid), tail(last_nf, vec, tid);
  auto issue = [&](int t) {
    if (t < slots) {
      float* s = ring + (t % kStages) * L.slot;
      int fp;
      int64_t c0;
      locate(t, fp, c0);
      const int f0 = fp * kMaxFeat;
      const Pieces& P = fp == L.parts - 1 ? tail : full;
      stage_rows(s, xc, c0, kCand, w, d, f0, L.pitch, vec, P);
      if (L.parts > 1)
        stage_rows(s + kCand * L.pitch + kCand, xr, r0, R, m, d, f0, L.pitch,
                   vec, P);
      if (Dist<M>::kNorms && fp == L.parts - 1) {
        float* sn = s + kCand * L.pitch;
        for (int p = tid; p < kCand / 4; p += kThreads) {
          const int64_t col = c0 + 4 * p;  // c0 % 4 == 0
          if (nvec && col + 4 <= w) {  // c0 % 4 == 0: aligned pieces
            cp_async16(sn + 4 * p, nc + col);
          } else {
            for (int q = 0; q < 4; ++q)
              if (col + q < w) cp_async4(sn + 4 * p + q, nc + col + q);
          }
        }
      }
    }
    cp_async_commit();
  };
  if (L.parts == 1) stage_rows(srows, xr, r0, R, m, d, 0, L.pitch, vec, full);
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  float acc[TR][4] = {};
  for (int t = 0; t < slots; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot t landed; slot t - 1 is free for slot t + 1
    issue(t + kStages - 1);
    const float* s = ring + (t % kStages) * L.slot;
    int fp;
    int64_t c0;
    locate(t, fp, c0);
    const int nf = fp == L.parts - 1 ? last_nf : L.kd;
    const float* rf = L.parts == 1 ? srows : s + kCand * L.pitch + kCand;
    const float* rw = rf + warp * TR * L.pitch;
    const float* cf = s + lane * L.pitch;
    const int n4 = nf / 4;
    for (int q = 0; q < n4; ++q) {
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(cf + 32 * j * L.pitch + 4 * q);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float4 av =
            *reinterpret_cast<const float4*>(rw + a * L.pitch + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[a][j] = Dist<M>::step(acc[a][j], av.x, b[j].x);
          acc[a][j] = Dist<M>::step(acc[a][j], av.y, b[j].y);
          acc[a][j] = Dist<M>::step(acc[a][j], av.z, b[j].z);
          acc[a][j] = Dist<M>::step(acc[a][j], av.w, b[j].w);
        }
      }
    }
    for (int f = 4 * n4; f < nf; ++f) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cf[32 * j * L.pitch + f];
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float av = rw[a * L.pitch + f];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[a][j] = Dist<M>::step(acc[a][j], av, b[j]);
      }
    }
    if (fp != L.parts - 1) continue;

    // finish the chunk's pairs: squares before the clamp at 0 (a negative
    // one is at or below every bound, and the clamp comes before its
    // root), cosine and manhattan in full; then flag each row whose least
    // pair is at or below the row's bound
    float nc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nc[j] = Dist<M>::kNorms ? s[kCand * L.pitch + lane + 32 * j] : 0.f;
    unsigned hit = 0;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int lr = warp * TR + a;
      const float nr = tn[lr];
      float least = inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kSquares)
          acc[a][j] = __fsub_rn(__fadd_rn(nr, nc[j]),
                                __fmul_rn(2.f, acc[a][j]));
        else
          acc[a][j] = Dist<M>::finish(acc[a][j], nr, nc[j]);
        least = fminf(least, acc[a][j]);
      }
      hit |= (least <= (kLazyRoot ? tb[lr] : tv[lr]) ? 1u : 0u) << a;
    }
    hit = __reduce_or_sync(0xffffffffu, hit);
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      if (hit >> a & 1) {
        const int lr = warp * TR + a;
        const int64_t row = r0 + lr;
        const int64_t grow = rg0 + row;
        float tva = tv[lr];
        int tia = ti[lr];
        const float tba = tb[lr];
        float rv = 0.f;  // kRegs: entry `lane` of the row's list
        int ri = 0;
        if constexpr (kRegs) {
          rv = lv_all[lr * 32 + lane];
          ri = li_all[lr * 32 + lane];
        }
        int cnt = 0;  // !kRegs: the batch so far
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t col = c0 + lane + 32 * j;
          const int gcol = static_cast<int>(cg0 + col);
          float v = acc[a][j];
          if constexpr (kSquares) v = v < 0.f ? 0.f : v;  // nan passes
          bool keep = row < m && col < w && cg0 + col != grow;
          if constexpr (kLazyRoot) {
            keep = keep && v <= tba;
            if (keep) v = __fsqrt_rn(v);
          }
          keep = keep && key_less(v, gcol, tva, tia);
          unsigned mask = __ballot_sync(0xffffffffu, keep);
          if constexpr (kRegs) {
            while (mask) {
              const int b = __ffs(mask) - 1;
              mask &= mask - 1;
              const float cv = __shfl_sync(0xffffffffu, v, b);
              const int cidx = __shfl_sync(0xffffffffu, gcol, b);
              if (!key_less(cv, cidx, tva, tia)) continue;
              insert_reg(rv, ri, k, cv, cidx, lane, tva, tia);
            }
          } else {
            if (keep) {
              const int at = cnt + __popc(mask & ((1u << lane) - 1));
              bv[at] = v;
              bi[at] = gcol;
            }
            cnt += __popc(mask);
          }
        }
        if constexpr (kRegs) {
          lv_all[lr * 32 + lane] = rv;
          li_all[lr * 32 + lane] = ri;
        } else {
          __syncwarp();
          if (cnt)
            merge_batch(lv_all + lr * k, li_all + lr * k, k, bv, bi, sv,
                        sidx, cnt, lane, tva, tia);
        }
        __syncwarp();
        if (lane == 0) {
          tv[lr] = tva;
          ti[lr] = tia;
          tb[lr] = root_bound(tva);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }
  cp_async_wait<0>();

  __syncwarp();
  for (int a = 0; a < TR; ++a) {
    const int lr = warp * TR + a;
    const int64_t row = r0 + lr;
    if (row >= m) continue;
    for (int e = lane; e < k; e += 32) {
      out_v[row * k + e] = lv_all[lr * lk + e];
      out_i[row * k + e] = li_all[lr * lk + e];
    }
  }
}

// ---------------------------------------------------------------------------
// the large-k variant (k > kLargeK): selection by threshold
// ---------------------------------------------------------------------------
// A finished distance as an unsigned key in the order of its value: -0 as
// +0 (they compare equal), the negative ones (cosine's rounding) below
// every non-negative one.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = v == 0.f ? 0u : __float_as_uint(v);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

// The largest finished pair whose key can lie at or below key u, as
// topk_large_kernel finishes pairs: the value of u, for euclidean the
// largest square whose root can (root_bound); +inf for the key of +inf and
// past it.
template <int M>
__device__ __forceinline__ float pair_bound(unsigned u) {
  const float v = __uint_as_float(u & 0x80000000u ? u & 0x7fffffffu : ~u);
  const float inf = __int_as_float(0x7f800000);
  if (!(v < inf)) return inf;
  return M == pald::kEuclidean ? root_bound(v) : v;
}

// Sort the cnt pairs (v, i) ascending by (value, index) with every thread
// of the block: the bitonic network whose merges all run ascending (the
// first step of each compares an entry with its mirror), so the cnt
// entries sort as if padded to a power of two with entries above every
// real one, which never move and are never read.  v and i lie in shared
// or device memory.
__device__ __forceinline__ void sort_pairs(float* v, int* i, int cnt) {
  int p = 1;
  while (p < cnt) p *= 2;
  for (int size = 2; size <= p; size *= 2) {
    for (int stride = size / 2; stride > 0; stride /= 2) {
      for (int e = threadIdx.x; e < p / 2; e += kThreads) {
        const int grp = e / stride, off = e - grp * stride;
        const int a = grp * 2 * stride + off;
        const int b = stride == size / 2
                          ? grp * 2 * stride + 2 * stride - 1 - off
                          : a + stride;
        if (b < cnt && key_less(v[b], i[b], v[a], i[a])) {
          const float tv = v[a];
          const int ti = i[a];
          v[a] = v[b];
          i[a] = i[b];
          v[b] = tv;
          i[b] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// Rows [0, m) of xr against the w candidates of xc, as topk_kernel's (the
// same staging, sums and finish); kLargeR rows a block, kLargeRows a
// warp.  A row's state lives in its warp's registers (warp-uniform), its
// histogram in shared memory.
template <int M, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
topk_large_kernel(const float* __restrict__ xr, const float* __restrict__ xc,
                  const float* __restrict__ nr, const float* __restrict__ nc,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int64_t m, int64_t w, int64_t rg0, int64_t cg0, int64_t d,
                  int k, bool vec) {
  constexpr int TR = kLargeRows, R = kLargeR;
  constexpr bool kLazyRoot = M == pald::kEuclidean;
  constexpr bool kSquares = M == pald::kSqEuclidean || kLazyRoot;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  const Layout L(d, R);
  float* srows = smem;                  // [R][pitch], d <= kMaxFeat
  float* ring = smem + L.rows;          // kStages slots
  float* tn = ring + kStages * L.slot;  // the rows' norms
  int* scnt = reinterpret_cast<int*>(tn + R);  // a row's entries to sort
  unsigned* hist = reinterpret_cast<unsigned*>(scnt + R);  // [R][kBins]

  if constexpr (kChunk) {  // this block's item of the chunk
    const int64_t item = blockIdx.y;
    xr += item * m * d;
    xc += item * w * d;
    nr += item * m;
    nc += item * w;
    out_v += item * m * k;
    out_i += item * m * k;
  }
  const bool nvec = !kChunk || reinterpret_cast<uintptr_t>(nc) % 16 == 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int chunks = static_cast<int>((w + kCand - 1) / kCand);
  const int slots = chunks * L.parts;
  const int64_t own = rg0 + r0 - cg0;
  const int home = own >= 0 && own < w ? static_cast<int>(own / kCand) : 0;
  const float inf = __int_as_float(0x7f800000);

  for (int e = tid; e < R * kBins; e += kThreads) hist[e] = 0;
  if (lane < TR) {
    const int64_t row = r0 + warp * TR + lane;
    tn[warp * TR + lane] = (Dist<M>::kNorms && row < m) ? nr[row] : 0.f;
  }
  // each row of the warp: K = min(k, its candidates); open while its K-th
  // key is not pinned: the keys [lo, hi] hold it, as the need-th of them
  int K[TR], need[TR];
  unsigned lo[TR], hi[TR];
  bool open[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int64_t row = r0 + warp * TR + a, grow = rg0 + row;
    const int64_t avail =
        row < m ? w - (grow >= cg0 && grow < cg0 + w ? 1 : 0) : 0;
    K[a] = static_cast<int>(avail < k ? avail : k);
    open[a] = avail > k;
    need[a] = K[a];
    lo[a] = 0;
    hi[a] = kAll;
  }

  // One sweep over the candidates, chunk by chunk from chunk `start` on
  // (wrapping): body(c0, v), v[a][j] the finished pair of row a and
  // candidate c0 + lane + 32 j (sqeuclidean and euclidean: the square, not
  // yet clamped).  A deliberate copy of topk_kernel's loop (lines 435-551,
  // from "slot t" through the finish of a chunk's pairs; here 764-876):
  // one device helper shared by both, in two forms, changed the SASS of
  // every k <= 1024 kernel (tools/sass_diff.py), which must keep it.  A
  // change to the ring, the norms' pieces, the sums or the finish is made
  // in both: each graph is bitwise the plain selection's only while both
  // kernels compute the same distance bits.
  auto sweep = [&](int start, auto&& body) {
    auto locate = [&](int t, int& fp, int64_t& c0) {
      int ci = t;
      fp = 0;
      if (L.parts > 1) {
        ci = t / L.parts;
        fp = t - ci * L.parts;
      }
      ci += start;
      if (ci >= chunks) ci -= chunks;
      c0 = static_cast<int64_t>(ci) * kCand;
    };
    const int last_nf = static_cast<int>(d - int64_t(L.parts - 1) * kMaxFeat);
    const Pieces full(L.kd, vec, tid), tail(last_nf, vec, tid);
    auto issue = [&](int t) {
      if (t < slots) {
        float* s = ring + (t % kStages) * L.slot;
        int fp;
        int64_t c0;
        locate(t, fp, c0);
        const int f0 = fp * kMaxFeat;
        const Pieces& P = fp == L.parts - 1 ? tail : full;
        stage_rows(s, xc, c0, kCand, w, d, f0, L.pitch, vec, P);
        if (L.parts > 1)
          stage_rows(s + kCand * L.pitch + kCand, xr, r0, R, m, d, f0,
                     L.pitch, vec, P);
        if (Dist<M>::kNorms && fp == L.parts - 1) {
          float* sn = s + kCand * L.pitch;
          for (int p = tid; p < kCand / 4; p += kThreads) {
            const int64_t col = c0 + 4 * p;
            if (nvec && col + 4 <= w) {
              cp_async16(sn + 4 * p, nc + col);
            } else {
              for (int q = 0; q < 4; ++q)
                if (col + q < w) cp_async4(sn + 4 * p + q, nc + col + q);
            }
          }
        }
      }
      cp_async_commit();
    };
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    float acc[TR][4] = {};
    for (int t = 0; t < slots; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(t + kStages - 1);
      const float* s = ring + (t % kStages) * L.slot;
      int fp;
      int64_t c0;
      locate(t, fp, c0);
      const int nf = fp == L.parts - 1 ? last_nf : L.kd;
      const float* rf = L.parts == 1 ? srows : s + kCand * L.pitch + kCand;
      const float* rw = rf + warp * TR * L.pitch;
      const float* cf = s + lane * L.pitch;
      const int n4 = nf / 4;
      for (int q = 0; q < n4; ++q) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(cf + 32 * j * L.pitch +
                                                  4 * q);
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float4 av =
              *reinterpret_cast<const float4*>(rw + a * L.pitch + 4 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[a][j] = Dist<M>::step(acc[a][j], av.x, b[j].x);
            acc[a][j] = Dist<M>::step(acc[a][j], av.y, b[j].y);
            acc[a][j] = Dist<M>::step(acc[a][j], av.z, b[j].z);
            acc[a][j] = Dist<M>::step(acc[a][j], av.w, b[j].w);
          }
        }
      }
      for (int f = 4 * n4; f < nf; ++f) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = cf[32 * j * L.pitch + f];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float av = rw[a * L.pitch + f];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[a][j] = Dist<M>::step(acc[a][j], av, b[j]);
        }
      }
      if (fp != L.parts - 1) continue;
      float ncj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ncj[j] = Dist<M>::kNorms ? s[kCand * L.pitch + lane + 32 * j] : 0.f;
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float nra = tn[warp * TR + a];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kSquares)
            acc[a][j] = __fsub_rn(__fadd_rn(nra, ncj[j]),
                                  __fmul_rn(2.f, acc[a][j]));
          else
            acc[a][j] = Dist<M>::finish(acc[a][j], nra, ncj[j]);
        }
      }
      body(c0, acc);
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next sweep
  };

  // pair (a, j) of the chunk at c0 from its finished `raw`: whether it is a
  // real candidate (for euclidean: with a square at or below top), and its
  // value v (the root taken only then)
  auto pair_value = [&](int a, int j, int64_t c0, float raw, float top,
                        float& v) {
    const int64_t col = c0 + lane + 32 * j;
    const int64_t grow = rg0 + r0 + warp * TR + a;
    bool keep = col < w && cg0 + col != grow;
    v = raw;
    if constexpr (kSquares) v = v < 0.f ? 0.f : v;  // nan passes
    if constexpr (kLazyRoot) {
      keep = keep && v <= top;
      if (keep) v = __fsqrt_rn(v);
    }
    return keep;
  };
  // does some lane hold a pair of row a at or below top (the raw pairs: a
  // square below 0 is at or below every bound, its clamp comes later)?
  auto any_below = [&](const float (&v)[4], float top) {
    const float least = fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
    return __any_sync(0xffffffffu, least <= top);
  };

  if (L.parts == 1)
    stage_rows(srows, xr, r0, R, m, d, 0, L.pitch, vec,
               Pieces(L.kd, vec, tid));
  __syncthreads();  // the histograms zero, the norms in place

  // the histogram sweeps: digit s of the keys in [lo, hi] of each open row
  for (int s = 0; s < 3; ++s) {
    bool any = false;
#pragma unroll
    for (int a = 0; a < TR; ++a) any |= open[a];
    if (!__syncthreads_or(any)) break;  // every row of the block pinned
    const int shift = s == 0 ? 21 : s == 1 ? 10 : 0;
    const unsigned mask = s == 2 ? 0x3ffu : 0x7ffu;
    // sweep 0: cut, the highest bin still counted, and cnt, the candidates
    // at or below it; a bin goes once the bins below it hold the row's need.
    // top: the largest raw pair whose key can lie at or below hi
    int cut[TR], cnt[TR];
    float top[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      cut[a] = kBins - 1;
      cnt[a] = 0;
      top[a] = pair_bound<M>(hi[a]);
    }
    sweep(home, [&](int64_t c0, const float(&v)[TR][4]) {
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        if (!open[a] || !any_below(v[a], top[a])) continue;
        unsigned* h = hist + (warp * TR + a) * kBins;
        int passed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x;
          bool keep = pair_value(a, j, c0, v[a][j], top[a], x);
          const unsigned u = order_key(x);
          keep = keep && u >= lo[a] && u <= hi[a];
          if (keep) atomicAdd(h + ((u >> shift) & mask), 1u);
          if (s == 0) passed += __popc(__ballot_sync(kAll, keep));
        }
        if (s == 0) {
          __syncwarp();
          int c = cut[a], n = cnt[a] + passed;
          if (lane == 0) {
            while (n - static_cast<int>(h[c]) >= need[a]) {
              n -= static_cast<int>(h[c]);
              --c;
            }
          }
          cut[a] = __shfl_sync(kAll, c, 0);
          cnt[a] = __shfl_sync(kAll, n, 0);
          hi[a] = (static_cast<unsigned>(cut[a]) << 21) | 0x1fffffu;
          top[a] = pair_bound<M>(hi[a]);
        }
      }
    });
    // each open row: the bin of its need-th key (lane l sums bins 64 l..
    // in a rotated order, so the 32 lanes read 32 banks)
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      if (!open[a]) continue;
      unsigned* h = hist + (warp * TR + a) * kBins;
      int sum = 0;
      for (int i = 0; i < 64; ++i) sum += h[64 * lane + ((i + lane) & 63)];
      int pre = sum;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(kAll, pre, o);
        if (lane >= o) pre += y;
      }
      pre -= sum;  // the bins of the lanes below
      const unsigned hit =
          __ballot_sync(kAll, pre < need[a] && need[a] <= pre + sum);
      const int src = __ffs(hit) - 1;
      int bin = 0, below = 0, in_bin = 0;
      if (lane == src) {
        below = pre;
        for (bin = 64 * lane; below + static_cast<int>(h[bin]) < need[a];
             ++bin)
          below += h[bin];
        in_bin = h[bin];
      }
      bin = __shfl_sync(kAll, bin, src);
      below = __shfl_sync(kAll, below, src);
      in_bin = __shfl_sync(kAll, in_bin, src);
      __syncwarp();
      for (int i = 0; i < 64; ++i) h[64 * lane + ((i + lane) & 63)] = 0;
      need[a] -= below;
      lo[a] += static_cast<unsigned>(bin) << shift;
      hi[a] = lo[a] + ((1u << shift) - 1u);
      open[a] = in_bin != need[a] && s < 2;  // else pinned
    }
  }

  // the collect: every key at or below `upto` (in arrival order), then
  // the first `ties` keys equal to T = lo (in ascending index, each key
  // alike): a row pinned to one key takes its need-th ties, a row pinned
  // to a bin the whole bin, a row with at most k candidates all of them
  unsigned upto[TR];
  int ties[TR], nin[TR], ntie[TR];
  float top[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    ties[a] = lo[a] == hi[a] ? need[a] : 0;
    upto[a] = ties[a] ? lo[a] - 1u : hi[a];
    nin[a] = ntie[a] = 0;
    top[a] = pair_bound<M>(hi[a]);
    const int64_t row = r0 + warp * TR + a;
    if (row < m)
      for (int e = K[a] + lane; e < k; e += 32) {  // past the candidates
        out_v[row * k + e] = inf;
        out_i[row * k + e] = kSentinel;
      }
  }
  sweep(0, [&](int64_t c0, const float(&v)[TR][4]) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      if (K[a] == 0 || !any_below(v[a], top[a])) continue;
      const int64_t row = r0 + warp * TR + a;
      float* ov = out_v + row * k;
      int* oi = out_i + row * k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x;
        const bool keep = pair_value(a, j, c0, v[a][j], top[a], x);
        const unsigned u = order_key(x);
        const int gcol = static_cast<int>(cg0 + c0 + lane + 32 * j);
        const bool in = keep && u <= upto[a];
        const bool tie = keep && ties[a] > 0 && u == lo[a];
        const unsigned mi = __ballot_sync(kAll, in);
        if (in) {
          const int at = nin[a] + __popc(mi & below);
          ov[at] = x;
          oi[at] = gcol;
        }
        nin[a] += __popc(mi);
        const unsigned mt = __ballot_sync(kAll, tie);
        if (tie) {
          const int t = ntie[a] + __popc(mt & below);
          if (t < ties[a]) {
            ov[K[a] - ties[a] + t] = x;
            oi[K[a] - ties[a] + t] = gcol;
          }
        }
        ntie[a] += __popc(mt);
      }
    }
  });
#pragma unroll
  for (int a = 0; a < TR; ++a)
    if (lane == 0) scnt[warp * TR + a] = K[a] - ties[a];
  __syncthreads();

  // sort each row's keys below T by (value, index): in shared memory (the
  // histograms' bytes) up to kSortCap entries, in the outputs past it
  float* sv = reinterpret_cast<float*>(hist);
  int* si = reinterpret_cast<int*>(hist) + kSortCap;
  for (int lr = 0; lr < R; ++lr) {
    const int cnt = scnt[lr];
    if (cnt < 2) continue;
    const int64_t row = r0 + lr;
    float* ov = out_v + row * k;
    int* oi = out_i + row * k;
    if (cnt <= kSortCap) {
      for (int e = tid; e < cnt; e += kThreads) {
        sv[e] = ov[e];
        si[e] = oi[e];
      }
      __syncthreads();
      sort_pairs(sv, si, cnt);
      for (int e = tid; e < cnt; e += kThreads) {
        ov[e] = sv[e];
        oi[e] = si[e];
      }
      __syncthreads();
    } else {
      sort_pairs(ov, oi, cnt);
    }
  }
}

// the selection's operands: rows xr (m) against candidates xc (w), their
// norm scratch buffers, the outputs, the global offsets, and the items of
// a chunk (each item's xr, xc, norms and outputs after the previous one's)
struct Operands {
  const float* xr;
  const float* xc;
  float* nr;
  float* nc;
  float* out_v;
  int* out_i;
  int64_t m, w, rg0, cg0, d;
  int k;
  bool vec;
  int64_t items;
  bool large;  // the large-k variant (selection by threshold)
};

template <int M, int TR, bool kRegs, bool kChunk>
int launch_rows(const Operands& o, cudaStream_t stream) {
  constexpr int R = kWarps * TR;
  const size_t smem = Layout(o.d, R).bytes(R, o.k);
  const auto kernel = topk_kernel<M, TR, kRegs, kChunk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((o.m + R - 1) / R);
  for (int64_t i0 = 0; i0 < o.items; i0 += kMaxItems) {
    const int64_t b = o.items - i0 < kMaxItems ? o.items - i0 : kMaxItems;
    const int64_t ok = i0 * o.m * o.k;
    kernel<<<dim3(grid, static_cast<unsigned>(b)), kThreads, smem, stream>>>(
            o.xr + i0 * o.m * o.d, o.xc + i0 * o.w * o.d, o.nr + i0 * o.m,
            o.nc + i0 * o.w, o.out_v + ok, o.out_i + ok, o.m, o.w, o.rg0,
            o.cg0, o.d, o.k, o.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// the large-k variant: kLargeR rows a block, at every k the same block
template <int M, bool kChunk>
int launch_large(const Operands& o, cudaStream_t stream) {
  const size_t smem = large_bytes(o.d);
  const auto kernel = topk_large_kernel<M, kChunk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((o.m + kLargeR - 1) / kLargeR);
  for (int64_t i0 = 0; i0 < o.items; i0 += kMaxItems) {
    const int64_t b = o.items - i0 < kMaxItems ? o.items - i0 : kMaxItems;
    const int64_t ok = i0 * o.m * o.k;
    kernel<<<dim3(grid, static_cast<unsigned>(b)), kThreads, smem, stream>>>(
        o.xr + i0 * o.m * o.d, o.xc + i0 * o.w * o.d, o.nr + i0 * o.m,
        o.nc + i0 * o.w, o.out_v + ok, o.out_i + ok, o.m, o.w, o.rg0, o.cg0,
        o.d, o.k, o.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <bool kChunk>
struct TopkPerMetric {
  Operands o;
  cudaStream_t stream;

  // the norm pre-pass over every item's rows (once when the rows are the
  // candidates), then the selection
  template <int M>
  int operator()() const {
    int status =
        pald::launch_row_norms<M>(o.xc, o.nc, o.items * o.w, o.d, stream);
    if (status == 0 && o.nr != o.nc)
      status = pald::launch_row_norms<M>(o.xr, o.nr, o.items * o.m, o.d,
                                         stream);
    if (status != 0) return status;
    if (o.large) return launch_large<M, kChunk>(o, stream);
    if (o.k <= 32)
      return launch_rows<M, warp_rows(32), true, kChunk>(o, stream);
    if (o.k <= 128)
      return launch_rows<M, warp_rows(128), false, kChunk>(o, stream);
    if (o.k <= 256)
      return launch_rows<M, warp_rows(256), false, kChunk>(o, stream);
    return launch_rows<M, warp_rows(kLargeK), false, kChunk>(o, stream);
  }
};

inline bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


// The k nearest other rows of each row of the row-major contiguous float32
// X (n, d) for `metric` (0 sqeuclidean, 1 euclidean, 2 cosine, 3
// manhattan): distances into out_v (n, k) float32 and indices into out_i
// (n, k) int32, each row ascending by (distance, index); for `items` such
// X (items, n, d), one after another, the (items, n, k) outputs of each
// item on its own, in one grid per 65535 items.  `norms` is an (items, n)
// float32 scratch buffer.  Needs 1 <= k <= n - 1, n < 2^31 and items >= 1;
// `large` (required past kLargeK) runs the large-k variant.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown metric or a shape out of range).
// kChunk: the kernel's chunk variant, the item on blockIdx.y.
template <bool kChunk>
int topk(const float* x, float* norms, float* out_v, int* out_i, int64_t n,
         int64_t d, int k, int64_t items, int large, int metric,
         void* stream) {
  if (n < 2 || d < 0 || k < 1 || k > n - 1 || (k > kLargeK && !large) ||
      n > static_cast<int64_t>(kSentinel) || items < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(x);
  const Operands o{x, x, norms, norms, out_v, out_i, n, n, 0, 0, d, k, vec,
                   items, large != 0};
  return pald::dispatch_metric(
      metric, TopkPerMetric<kChunk>{o, static_cast<cudaStream_t>(stream)});
}

}  // namespace pald::topk
