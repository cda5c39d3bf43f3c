// Sphere-trace march against packed primitive scenes, for Hopper (sm_90a).
//
// Replaces the march mode of the TPU tile body
// visfly_tpu/render/pallas_trace.py::_trace_tile (_march) behind its three
// entries: _trace_kernel_culled (component-major rays, per-tile cull: CULL),
// _trace_kernel_c (component-major rays, every row) and _trace_kernel (packed
// (S, R, 3) rays with a warm start, the second stage of the cone prepass:
// PACKED). Per ray: n_steps of t += sdf(o + t*d) from t_init while
// sdf >= eps and t < max_depth, then t = clamp(t + sdf(o + t*d), 0,
// max_depth) and hit = t < max_depth. omega > 1 over-relaxes the step with
// the safeguard of Keinert et al. (RELAXED): when the safe spheres of two
// consecutive samples stop overlapping the ray steps back inside the previous
// one and marches plainly from then on. A dynamic capsule that holds a ray's
// origin is invisible to that ray.
//
// One block of 1,024 threads owns one tile of 1,024 rays, the TPU kernel's
// (8, 128) block, and blockIdx.y is the scene; each thread marches one ray.
// Two blocks share an SM (32 registers a thread, a few spilled), which
// hides more latency than one block of 53-64 registers without spills or
// than 256 threads marching four rays each (PERF.md, §6). On camera rays
// (img_w) a warp's lanes take an 8 x 4 patch of pixels rather than half an
// image row: a warp runs until its slowest lane is done, and neighbouring
// pixels need like numbers of evaluations (tile_ray).
//
// Staging, all modes: the block copies its scene's rows into shared memory
// once, with the row constants formed there: a box as 3 float4
// [cx cy cz cos] [sin hx hy hz] [r sign - -], a capsule as 2 float4
// [ax ay az r] [bax bay baz 1/(ba.ba + 1e-9)] (trace_rows.cuh's operations,
// so the bits are the plain version's). Inactive rows are left out, static
// capsules go first and dynamic ones at the end, so the SDF reads 3 or 2
// vector loads a row and has no division and no per-row flag. The minimum
// over rows is exact, so the staging order changes no bit of the result.
//
// CULL, the port of cull_compact (plain version:
// render/trace_kernel.py::cull_rows), in trace_rows.cuh, which the analytic
// kernel shares: the block reduces its tile's origin and direction bounds
// and, with img_w > 0, forms the four frustum planes (tile_reach); then it
// tests every row, one a thread, with the plain version's formulas in its
// order, ranks the rows in stable order (culled-in first) with a ballot scan
// (rank_rows), and stages the first kb_c box and kc_c capsule rows of that
// order where both counts fit, else every row (tile_evaluates). The
// culled-out filler rows are part of the function. cnt_out, where given,
// receives each tile's (nb, nc). The march itself, march_rows, is the
// analytic kernel's refine too.
//
// Bound: 33 bytes a ray (six components, t_init, t, hit) against
// evaluations * rows * ~40 operations: operations bind, by a factor that
// grows with the steps the rays need. No product and no tile to move, so no
// tensor core and no TMA.
//
// Built with --fmad=false and without --use_fast_math, as trace_analytic.cu:
// a differently rounded distance near eps ends a ray's march a step early,
// which at eps = 0.01 can move t by more than 1e-3 m.

#include "trace_rows.cuh"

namespace {

using namespace vf;

// The ray of a 1,024-ray tile that this thread marches. Where the tile holds
// whole rows of a camera patch_w rays wide (patch_w > 0: a multiple of 8
// that divides 1,024 into 4 rows or more), warp w takes the w-th 8 x 4 patch
// of pixels, patches counted down each column of patches first; else warp w
// takes rays 32 w to 32 w + 31.
__device__ __forceinline__ int tile_ray(int patch_w) {
  if (patch_w == 0) return threadIdx.x;
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int prows = kTile / patch_w / 4;  // patches down the tile
  return ((p % prows) * 4 + (lane >> 3)) * patch_w + (p / prows) * 8 + (lane & 7);
}

template <bool PACKED, bool RELAXED, bool CULL>
__global__ void __launch_bounds__(kTile, 2)
trace_march_kernel(const float* __restrict__ boxes, const float* __restrict__ caps,
                   const float* __restrict__ origins, const float* __restrict__ dirs,
                   const float* __restrict__ t_init, float* __restrict__ t_out,
                   bool* __restrict__ hit_out, int* __restrict__ cnt_out, int S, int R,
                   int KB, int KC, int kb_c, int kc_c, int img_w, int n_steps,
                   float max_depth, float eps, float omega, float one_minus_omega) {
  extern __shared__ float4 smem[];
  float4* sb = smem;             // staged boxes
  float4* sc = smem + KB * kBox4;  // staged capsules: static from the front, dynamic at the end
  int* rank = reinterpret_cast<int*>(sc + KC * kCap4);  // CULL: culled-in rows ahead, KB + KC
  int* in = rank + KB + KC;                             // CULL: culled in, KB + KC
  __shared__ TileCull tc;
  __shared__ int s_n[3];  // staged boxes, static capsules, dynamic capsules

  const int s = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const float* bs = boxes + (size_t)s * KB * kBoxCols;
  const float* cs = caps + (size_t)s * KC * kCapCols;
  const size_t plane = (size_t)S * R;
  const size_t row0 = (size_t)s * R + tile0;
  if (threadIdx.x < 3) s_n[threadIdx.x] = 0;

  bool every_row = true;
  int2 n_in = make_int2(0, 0);  // culled-in rows of each family
  if (CULL) {
    float mn[6], mx[6];
    for (int c = 0; c < 3; ++c) {
      mn[c] = mx[c] = origins[c * plane + row0 + threadIdx.x];
      mn[3 + c] = mx[3 + c] = dirs[c * plane + row0 + threadIdx.x];
    }
    tile_reach(
        tc, mn, mx,
        [&](int q, int c) { return dirs[c * plane + row0 + corner_ray(q, img_w)]; },
        [&](int c) { return origins[c * plane + row0]; }, max_depth, img_w);
    n_in = rank_rows<true>(tc, bs, KB, cs, KC, img_w, rank, in);
    every_row = !(n_in.x <= kb_c && n_in.y <= kc_c);
    if (cnt_out != nullptr && threadIdx.x == 0) {
      const size_t tile = (size_t)s * gridDim.x + blockIdx.x;
      cnt_out[2 * tile] = n_in.x;
      cnt_out[2 * tile + 1] = n_in.y;
    }
  } else {
    __syncthreads();  // s_n
  }
  stage_march_rows(sb, sc, s_n, bs, KB, cs, KC, every_row, rank, in, n_in.x, n_in.y, kb_c,
                   kc_c);
  __syncthreads();
  const int n_box = s_n[0], n_static = s_n[1], n_dyn = s_n[2];
  const float4* sd = sc + (KC - n_dyn) * kCap4;
  const int patch_w =
      img_w > 0 && img_w % 8 == 0 && kTile / img_w >= 4 && R % kTile == 0 ? img_w : 0;

  const int r = tile0 + tile_ray(patch_w);
  if (r >= R) return;  // ragged last tile
  const size_t idx = (size_t)s * R + r;
  float ox, oy, oz, dx, dy, dz;
  if (PACKED) {
    const float* o = origins + 3 * idx;
    const float* d = dirs + 3 * idx;
    ox = o[0]; oy = o[1]; oz = o[2];
    dx = d[0]; dy = d[1]; dz = d[2];
  } else {
    ox = origins[idx]; oy = origins[plane + idx]; oz = origins[2 * plane + idx];
    dx = dirs[idx]; dy = dirs[plane + idx]; dz = dirs[2 * plane + idx];
  }
  const float t = march_rows<RELAXED>(sb, n_box, sc, n_static, sd, n_dyn, ox, oy, oz, dx, dy,
                                      dz, t_init != nullptr ? t_init[idx] : 0.0f, n_steps,
                                      max_depth, eps, omega, one_minus_omega);
  t_out[idx] = t;
  hit_out[idx] = t < max_depth;
}

}  // namespace

// Shared memory one block takes, in bytes: the staged rows (12 floats a box,
// 8 a capsule), for the cull two ints a row, and at most 2 KB of static
// scratch (TileCull and the rest). The wrapper checks a scene against it before
// it launches; the launch refuses more than 48 KB.
constexpr int kStaticSmem = 2048;

static int dynamic_smem(int KB, int KC, int cull) {
  return (KB * kBox4 + KC * kCap4) * (int)sizeof(float4) +
         (cull ? (KB + KC) * 2 * (int)sizeof(int) : 0);
}

extern "C" int trace_march_smem(int KB, int KC, int cull) {
  return dynamic_smem(KB, KC, cull) + kStaticSmem;
}

// packed != 0 reads (S, R, 3) rays, else (3, S, R); cull != 0 culls each tile
// (component-major rays, R a multiple of 1,024) with capacities kb_c, kc_c.
// img_w > 0 (a divisor of 1,024) says the rays are images of a camera img_w
// rays wide: the cull's frustum planes, and the patches of tile_ray.
// t_init and cnt_out may be null (t_init: a cold start at 0).
// one_minus_omega is 1 - omega rounded once by the caller, the same float32
// the plain version multiplies by. Returns the CUDA error of the launch;
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int trace_march_launch(const float* boxes, const float* caps,
                                  const float* origins, const float* dirs,
                                  const float* t_init, float* t_out, bool* hit_out,
                                  int* cnt_out, int S, int R, int KB, int KC, int kb_c,
                                  int kc_c, int img_w, int n_steps, float max_depth, float eps,
                                  float omega, float one_minus_omega, int packed, int cull,
                                  cudaStream_t stream) {
  const int smem = dynamic_smem(KB, KC, cull);
  if ((packed && (omega > 1.0f || cull)) || (cull && R % kTile != 0) ||
      (img_w > 0 && kTile % img_w != 0) || trace_march_smem(KB, KC, cull) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kTile - 1) / kTile, S);
#define VF_LAUNCH(PACKED, RELAXED, CULL)                                                      \
  trace_march_kernel<PACKED, RELAXED, CULL><<<grid, kTile, smem, stream>>>(                  \
      boxes, caps, origins, dirs, t_init, t_out, hit_out, cnt_out, S, R, KB, KC, kb_c, kc_c,  \
      img_w, n_steps, max_depth, eps, omega, one_minus_omega)
  if (packed) {
    VF_LAUNCH(true, false, false);
  } else if (omega > 1.0f) {
    if (cull) VF_LAUNCH(false, true, true);
    else VF_LAUNCH(false, true, false);
  } else {
    if (cull) VF_LAUNCH(false, false, true);
    else VF_LAUNCH(false, false, false);
  }
#undef VF_LAUNCH
  return (int)cudaGetLastError();
}
