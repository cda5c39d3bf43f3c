// Analytic first-hit ray trace against packed primitive scenes, for Hopper
// (sm_90a).
//
// Replaces the analytic mode of the TPU kernel
// visfly_tpu/render/pallas_trace.py::_trace_kernel_culled (tile body
// _trace_tile(analytic=True)). Per ray it computes the closed-form first hit
// over one scene's rows (trace_rows.cuh: slab test of the radius-inflated
// yaw-rotated box, slab exit for hollow rooms, sphere quadratic, capsule
// cylinder plus end caps), t = clamp(min_k t_k, 0, max_depth) and
// hit = t < max_depth, with rays component-major (3, S, R), so each load and
// store is coalesced. Two options, each a template flag so that a render
// which does not ask for one does not pay for it:
//   KID     also the packed-row id (the rows' id column) of the first strict
//           minimum in row order, boxes then capsules; -1 on a miss and on a
//           dynamic capsule (whose id column is -1);
//   REFINE  n_refine march steps from the candidate and one residual SDF
//           evaluation, which converge the lower-bound candidate of a general
//           rounded box (half extents > 0 and radius > 0).
//
// One thread traces one ray; blockIdx.y is the scene, whose rows the block
// stages in shared memory ((KB*13 + KC*9)*4 bytes, under 1 KB for the
// bench garage) and every thread walks in a runtime loop. The TPU kernel's
// static unroll, one-hot compaction and per-tile cull were Mosaic
// workarounds; the cull never changes t, hit or kid in this mode and is
// left out.
//
// Bound at the main-path size (S = 1, R = 1,048,576, KB = 8, KC = 12): 29
// bytes a ray (33 with the id), ~30 MB, 9 us at 3.35 TB/s; the arithmetic
// is ~100 IEEE divisions and square roots a ray, each a sequence of ~8
// instructions, so the kernel is bound by operations, not bytes.
//
// Built without --use_fast_math (approximate sqrt and division move t by
// several ulps and flip hits on grazing rays) and with --fmad=false, so each
// operation rounds as in the plain PyTorch version: grazing rays amplify a
// one-ulp difference in a slab division into millimetres of t.

#include "trace_rows.cuh"

namespace {

using namespace vf;

template <bool KID, bool REFINE>
__global__ void trace_analytic_kernel(const float* __restrict__ boxes,
                                      const float* __restrict__ caps,
                                      const float* __restrict__ origins,
                                      const float* __restrict__ dirs,
                                      float* __restrict__ t_out,
                                      bool* __restrict__ hit_out,
                                      float* __restrict__ kid_out,
                                      int S, int R, int KB, int KC, float max_depth,
                                      int n_refine, float eps) {
  extern __shared__ float rows[];
  const float* sb = rows;
  const float* sc = rows + KB * kBoxCols;
  const int s = blockIdx.y;
  stage_rows(rows, boxes, caps, s, KB, KC);
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;  // ragged last block
  const size_t plane = (size_t)S * R;
  const size_t idx = (size_t)s * R + r;
  const float ox = origins[idx], oy = origins[plane + idx], oz = origins[2 * plane + idx];
  const float dx = dirs[idx], dy = dirs[plane + idx], dz = dirs[2 * plane + idx];

  float best = kBig;
  float kbest = -1.0f;
  for (int k = 0; k < KB; ++k) {
    const float* b = sb + k * kBoxCols;
    if (b[11] > 0.5f) {
      const float tk = box_hit(b, ox, oy, oz, dx, dy, dz);
      if (KID && tk < best) kbest = b[12];
      best = fminf(best, tk);
    }
  }
  for (int k = 0; k < KC; ++k) {
    const float* c = sc + k * kCapCols;
    if (c[7] > 0.5f) {
      const float tk = capsule_hit(c, ox, oy, oz, dx, dy, dz);
      if (KID && tk < best) kbest = c[8];
      best = fminf(best, tk);
    }
  }
  if (KID) kid_out[idx] = best < max_depth ? kbest : -1.0f;
  float t = fminf(best, max_depth);
  if (REFINE) {
    t = march(sb, KB, sc, KC, ox, oy, oz, dx, dy, dz, t, n_refine, max_depth, eps);
    t = final_eval(sb, KB, sc, KC, ox, oy, oz, dx, dy, dz, t, max_depth);
  } else {
    t = fminf(fmaxf(t, 0.0f), max_depth);
  }
  t_out[idx] = t;
  hit_out[idx] = t < max_depth;
}

}  // namespace

// kid_out == nullptr selects the kernels without the id; n_refine == 0 those
// without the refine.
extern "C" int trace_analytic_launch(const float* boxes, const float* caps,
                                     const float* origins, const float* dirs,
                                     float* t_out, bool* hit_out, float* kid_out,
                                     int S, int R, int KB, int KC, float max_depth,
                                     int n_refine, float eps, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, S);
  const size_t smem = (size_t)(KB * kBoxCols + KC * kCapCols) * sizeof(float);
#define VF_LAUNCH(KID, REFINE)                                                         \
  trace_analytic_kernel<KID, REFINE><<<grid, kThreads, smem, stream>>>(                \
      boxes, caps, origins, dirs, t_out, hit_out, kid_out, S, R, KB, KC, max_depth,    \
      n_refine, eps)
  if (kid_out != nullptr) {
    if (n_refine > 0) VF_LAUNCH(true, true); else VF_LAUNCH(true, false);
  } else {
    if (n_refine > 0) VF_LAUNCH(false, true); else VF_LAUNCH(false, false);
  }
#undef VF_LAUNCH
  return (int)cudaGetLastError();
}
