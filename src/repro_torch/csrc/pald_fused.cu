// PaLD's two passes on Hopper straight from feature vectors, one item:
//
//     U[x, y] = sum_z focus(d(x, z), d(y, z), d(x, y))
//     C[x, z] = sum_y support(d(x, z), d(y, z), d(x, y), x > y) * W[x, y]
//
// with d(a, b) computed from the rows of X (n, d) on the card.  Replaces
// the TPU kernels repro/kernels/pald_fused.py::focus_fused_pallas and
// cohesion_fused_pallas; the kernels, what bounds them and their design are
// in pald_fused.cuh.  pald_fused_chunk.cu holds the entry points of a
// chunk of items.
#include "pald_fused.cuh"

// U (n, n) from row-major contiguous float32 X (n, d): pald_fused.cuh's
// focus_fused for one item (`norms` (n,), `panel` (panel_rows, ldp)).
extern "C" int pald_focus_fused_f32(const float* x, float* norms,
                                    float* panel, float* u, int64_t n,
                                    int64_t d, int64_t n_valid,
                                    int64_t panel_rows, int metric, int wid,
                                    float p0, float p1, void* stream) {
  return pald::fused::focus_fused<false>(x, norms, panel, u, n, d, n_valid,
                                         panel_rows, 1, metric, wid, p0, p1,
                                         stream);
}

// C (n, n) from X (n, d) and the weights W = 1/U (n, n): pald_fused.cuh's
// cohesion_fused for one item.
extern "C" int pald_cohesion_fused_f32(const float* x, float* norms,
                                       float* panel, const float* w, float* c,
                                       int64_t n, int64_t d, int64_t n_valid,
                                       int64_t panel_rows, int metric,
                                       int wid, float p0, float p1, int add,
                                       void* stream) {
  return pald::fused::cohesion_fused<false>(x, norms, panel, w, c, n, d,
                                            n_valid, panel_rows, 1, metric,
                                            wid, p0, p1, add, stream);
}

// D (n, n): the fused kernels' masked distances, written out by the panel
// writer's code.
extern "C" int pald_dist_fused_f32(const float* x, float* norms, float* out,
                                   int64_t n, int64_t d, int64_t n_valid,
                                   int metric, void* stream) {
  using namespace pald::fused;
  if (bad_shape(n, d, n_valid, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, norms, nullptr, nullptr, out, n, d, n_valid, kTile, 1,
               {0.f, 0.f}, static_cast<cudaStream_t>(stream)};
  return pald::dispatch_metric(metric, DistPerMetric{a});
}
