// Sphere-trace march against packed primitive scenes, for Hopper (sm_90a).
//
// Replaces the march mode of the TPU tile body
// visfly_tpu/render/pallas_trace.py::_trace_tile (_march) behind its three
// entries: _trace_kernel_culled and _trace_kernel_c (component-major rays,
// with and without the per-tile cull) and _trace_kernel (packed (S, R, 3)
// rays with a warm start, the second stage of the cone prepass). Per ray:
// n_steps of t += sdf(o + t*d) from t_init while sdf >= eps and
// t < max_depth, then t = clamp(t + sdf(o + t*d), 0, max_depth) and
// hit = t < max_depth. omega > 1 over-relaxes the step with the safeguard of
// Keinert et al. (trace_rows.cuh::march). A dynamic capsule that holds a
// ray's origin is invisible to that ray.
//
// One thread marches one ray and keeps t (and, over-relaxed, the previous
// radius, the step length and omega) in registers for all steps; blockIdx.y
// is the scene, whose rows the block stages in shared memory. A ray that is
// done leaves its loop, which the TPU tile could not do. The per-tile cull
// of the TPU kernel is not ported: this kernel evaluates every active row,
// so it computes the un-culled entry's function for both cull settings (a
// culled march can step farther on rays that exhaust n_steps).
//
// PACKED reads rays as (S, R, 3): a block's 256 rays are 768 consecutive
// floats, which the block copies to shared memory with coalesced loads and
// each thread then reads as its three components. It has no over-relaxed
// form, as the TPU entry has none.
//
// Bound: 33 bytes a ray (six components, t_init, t, hit) against
// steps * active rows * ~40 operations: operations bind, by a factor that
// grows with the steps the rays need.
//
// Built with --fmad=false and without --use_fast_math, as trace_analytic.cu:
// a differently rounded distance near eps ends a ray's march a step early.

#include "trace_rows.cuh"

namespace {

using namespace vf;

template <bool PACKED, bool RELAXED>
__global__ void trace_march_kernel(const float* __restrict__ boxes,
                                   const float* __restrict__ caps,
                                   const float* __restrict__ origins,
                                   const float* __restrict__ dirs,
                                   const float* __restrict__ t_init,
                                   float* __restrict__ t_out,
                                   bool* __restrict__ hit_out,
                                   int S, int R, int KB, int KC, int n_steps,
                                   float max_depth, float eps, float omega,
                                   float one_minus_omega) {
  extern __shared__ float rows[];
  __shared__ float rays[PACKED ? 2 * 3 * kThreads : 1];
  const float* sb = rows;
  const float* sc = rows + KB * kBoxCols;
  const int s = blockIdx.y;
  stage_rows(rows, boxes, caps, s, KB, KC);
  const int r0 = blockIdx.x * blockDim.x;
  if (PACKED) {
    const int n = 3 * min((int)blockDim.x, R - r0);
    const size_t base = ((size_t)s * R + r0) * 3;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      rays[i] = origins[base + i];
      rays[3 * kThreads + i] = dirs[base + i];
    }
  }
  __syncthreads();

  const int r = r0 + threadIdx.x;
  if (r >= R) return;  // ragged last block
  const size_t idx = (size_t)s * R + r;
  float ox, oy, oz, dx, dy, dz;
  if (PACKED) {
    const float* o = rays + 3 * threadIdx.x;
    const float* d = rays + 3 * kThreads + 3 * threadIdx.x;
    ox = o[0]; oy = o[1]; oz = o[2];
    dx = d[0]; dy = d[1]; dz = d[2];
  } else {
    const size_t plane = (size_t)S * R;
    ox = origins[idx]; oy = origins[plane + idx]; oz = origins[2 * plane + idx];
    dx = dirs[idx]; dy = dirs[plane + idx]; dz = dirs[2 * plane + idx];
  }

  float t = march<RELAXED>(sb, KB, sc, KC, ox, oy, oz, dx, dy, dz, t_init[idx], n_steps,
                           max_depth, eps, omega, one_minus_omega);
  t = final_eval(sb, KB, sc, KC, ox, oy, oz, dx, dy, dz, t, max_depth);
  t_out[idx] = t;
  hit_out[idx] = t < max_depth;
}

}  // namespace

// packed != 0 reads (S, R, 3) rays, else (3, S, R). one_minus_omega is
// 1 - omega rounded once by the caller, so that it is the same float32 the
// plain version multiplies by. Returns the CUDA error of the launch;
// cudaErrorInvalidValue for packed rays with omega > 1.
extern "C" int trace_march_launch(const float* boxes, const float* caps,
                                  const float* origins, const float* dirs,
                                  const float* t_init, float* t_out, bool* hit_out,
                                  int S, int R, int KB, int KC, int n_steps,
                                  float max_depth, float eps, float omega,
                                  float one_minus_omega, int packed,
                                  cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, S);
  const size_t smem = (size_t)(KB * kBoxCols + KC * kCapCols) * sizeof(float);
#define VF_LAUNCH(PACKED, RELAXED)                                                     \
  trace_march_kernel<PACKED, RELAXED><<<grid, kThreads, smem, stream>>>(               \
      boxes, caps, origins, dirs, t_init, t_out, hit_out, S, R, KB, KC, n_steps,       \
      max_depth, eps, omega, one_minus_omega)
  if (packed) {
    if (omega > 1.0f) return (int)cudaErrorInvalidValue;
    VF_LAUNCH(true, false);
  } else if (omega > 1.0f) {
    VF_LAUNCH(false, true);
  } else {
    VF_LAUNCH(false, false);
  }
#undef VF_LAUNCH
  return (int)cudaGetLastError();
}
