// Analytic first-hit ray trace against packed primitive scenes, for Hopper
// (sm_90a).
//
// Replaces the analytic mode of the TPU kernel
// visfly_tpu/render/pallas_trace.py::_trace_kernel_culled (tile body
// _trace_tile(analytic=True)) and of its un-culled entry _trace_kernel_c.
// Per ray: the closed-form first hit over the rows (trace_rows.cuh: slab test
// of the radius-inflated yaw-rotated box, slab exit for hollow rooms, sphere
// quadratic, capsule cylinder plus end caps), t = clamp(min_k t_k, 0,
// max_depth) and hit = t < max_depth, rays component-major (3, S, R). Each
// option is a template flag, so a render that does not ask for one does not
// pay for it:
//   KID     also the packed-row id (the rows' id column) of the first strict
//           minimum in row order, boxes then capsules; -1 on a miss;
//   REFINE  n_refine march steps from the candidate and the residual
//           evaluation (trace_rows.cuh's march_rows, the march kernel's),
//           which converge the lower-bound candidate of a rounded box;
//   CULL    the per-tile cull of the TPU kernel (trace_rows.cuh, shared with
//           trace_march.cu; plain version render/trace_kernel.py::cull_rows):
//           the closed form runs over the rows that meet the tile only. A row
//           the cull keeps out has no hit nearer than max_depth, so t, hit
//           and kid are the TPU tile's, which also runs over filler rows where
//           they fit and over every row where they do not. The refine marches
//           the TPU tile's row set, filler rows included, since a minimum
//           over other SDFs would move t.
//
// One block owns one 1,024-ray tile (kTile); blockIdx.y is the scene. The
// block copies its scene's rows into shared memory while its rays load,
// ranks the rows that pass (the cull, or every active row) in stable order
// and stages them once, in scene order, with their row constants (capsule
// axis, ba.ba and its reciprocal; box h + r and the row's form). Where every
// ray of the tile has one origin, bit for bit (a camera's rows: every tile
// of a render of whole 1,024-ray tiles), one thread a row forms the origin's
// terms once (box: the rotated origin, the slab numerators and the sphere's
// cs; capsule: the inside test with its square root, oa, ba.oa, Cq and each
// end sphere's cc) with the same operations as the per-ray path, so each ray
// forms only its direction's terms. Other tiles (random rays) form every term
// per ray. A ray whose capsule quadratic or end sphere has no root takes no
// square root and no division, and a solid box that two slabs miss skips the
// third: exact early-outs.
//
// Bound at the main-path size (1,048,576 camera rays; path B: 5 box and 10
// capsule rows active, 2.78 and 5.59 culled in a tile; path A: 2 box rows):
// 29 bytes a ray (33 with the id), 9-10 us at 3.35 TB/s, against ~580
// float32 operations a ray on path B (chip_smoke.py's OPS): the two tie. There is no product and no tile to copy: no wgmma and no TMA.
//
// Block shape (PERF.md, section 6): 256 threads of 4 consecutive rays each
// (16-byte loads of each component plane, one 4-byte store of four hit
// flags) at 4 blocks an SM (64 registers) beat 1,024 threads of one ray at 1
// or 2 blocks an SM by 1.1-1.8x: the per-tile ranking, reductions and
// barriers cost a 1,024-thread block several microseconds that 256 threads
// do not. At 8 blocks an SM (32 registers) they spill. chip_profile.py
// analytic rebuilds a copy of this source at other kMinBlocks.
//
// Built without --use_fast_math (approximate sqrt and division move t by
// several ulps and flip hits on grazing rays) and with --fmad=false, so each
// operation rounds as in the plain PyTorch version: grazing rays amplify a
// one-ulp difference in a slab division into millimetres of t.

#include <stdint.h>

#include "trace_rows.cuh"

namespace {

using namespace vf;

constexpr int kRays = 4;  // consecutive rays a thread: one float4 of each plane
constexpr int kThreads = kTile / kRays;
constexpr int kMinBlocks = 4;  // blocks an SM in the launch bounds: 64 registers

// float4 that the rows of one scene take as in device memory
__host__ __device__ __forceinline__ int raw_float4(int KB, int KC) {
  return (KB * kBoxCols + KC * kCapCols + 3) / 4;
}

template <bool KID, bool REFINE, bool CULL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_analytic_kernel(const float* __restrict__ boxes, const float* __restrict__ caps,
                      const float* __restrict__ origins, const float* __restrict__ dirs,
                      float* __restrict__ t_out, bool* __restrict__ hit_out,
                      float* __restrict__ kid_out, int S, int R, int KB, int KC, int kb_c,
                      int kc_c, int img_w, float max_depth, int n_refine, float eps, int vec) {
  extern __shared__ float4 smem[];
  float* bs = reinterpret_cast<float*>(smem);  // the scene's rows as in device memory
  float* cs = bs + KB * kBoxCols;
  float4* hb = smem + raw_float4(KB, KC);  // closed-form boxes in rank order, kHit4 each
  float4* hc = hb + KB * kHit4;            // closed-form capsules in rank order
  float4* mb = hc + KC * kHit4;   // REFINE: the march's boxes
  float4* mc = mb + (REFINE ? KB * kBox4 : 0);  // REFINE: the march's capsules
  int* rank = reinterpret_cast<int*>(mc + (REFINE ? KC * kCap4 : 0));  // KB + KC
  int* in = rank + KB + KC;                                            // KB + KC
  __shared__ TileCull tc;
  __shared__ int s_n[3];  // REFINE: staged march boxes, static and dynamic capsules

  const int s = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const size_t plane = (size_t)S * R;
  const size_t row0 = (size_t)s * R + tile0;
  if (threadIdx.x < 3) s_n[threadIdx.x] = 0;
  // the rows into shared memory, their loads in flight with the rays'
  for (int i = threadIdx.x; i < KB * kBoxCols; i += kThreads)
    bs[i] = boxes[(size_t)s * KB * kBoxCols + i];
  for (int i = threadIdx.x; i < KC * kCapCols; i += kThreads)
    cs[i] = caps[(size_t)s * KC * kCapCols + i];

  // this thread's rays: kRays consecutive rays of the tile
  const int r0 = tile0 + threadIdx.x * kRays;
  const size_t idx0 = (size_t)s * R + r0;
  auto load_rays = [&](const float* __restrict__ src, float (&v)[kRays][3]) {
    if (vec) {  // R % 4 == 0: a thread's rays are all in the tile or all out
      for (int c = 0; c < 3; ++c) {
        const float4 q = r0 < R ? *reinterpret_cast<const float4*>(src + c * plane + idx0)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float qa[4] = {q.x, q.y, q.z, q.w};
        for (int j = 0; j < kRays; ++j) v[j][c] = qa[j];
      }
    } else {
      for (int j = 0; j < kRays; ++j)
        for (int c = 0; c < 3; ++c) v[j][c] = r0 + j < R ? src[c * plane + idx0 + j] : 0.0f;
    }
  };
  float o[kRays][3], d[kRays][3];
  load_rays(origins, o);
  load_rays(dirs, d);

  // the corner rays' directions for the frustum planes
  if (CULL && img_w > 0) {
    for (int j = 0; j < kRays; ++j)
      for (int q = 0; q < 4; ++q)
        if ((int)threadIdx.x * kRays + j == corner_ray(q, img_w))
          for (int c = 0; c < 3; ++c) tc.corner[q][c] = d[j][c];
  }

  // one origin for the whole tile? (bit patterns: -0.0 and 0.0 differ); the
  // barrier also publishes the rows and the corners
  float o0[3];
  bool same = true;
  for (int c = 0; c < 3; ++c) o0[c] = origins[c * plane + row0];
  for (int j = 0; j < kRays; ++j)
    for (int c = 0; c < 3; ++c)
      same = same && (r0 + j >= R || __float_as_uint(o[j][c]) == __float_as_uint(o0[c]));
  const bool one_origin = __syncthreads_and(same);

  if (CULL) {  // whole tiles: every ray is valid
    float mn[6], mx[6];
    for (int c = 0; c < 3; ++c) {
      mn[c] = mx[c] = o[0][c];
      mn[3 + c] = mx[3 + c] = d[0][c];
    }
    for (int j = 1; j < kRays; ++j) {
      for (int c = 0; c < 3; ++c) {
        mn[c] = fminf(mn[c], o[j][c]);
        mx[c] = fmaxf(mx[c], o[j][c]);
        mn[3 + c] = fminf(mn[3 + c], d[j][c]);
        mx[3 + c] = fmaxf(mx[3 + c], d[j][c]);
      }
    }
    tile_reach(
        tc, mn, mx, [&](int q, int c) { return tc.corner[q][c]; },
        [&](int c) { return o0[c]; }, max_depth, img_w);
  }
  const int2 n_in = rank_rows<CULL>(tc, bs, KB, cs, KC, img_w, rank, in);

  // stage the rows that pass in rank order, as origin terms on one-origin tiles
  for (int k = threadIdx.x; k < KB; k += kThreads) {
    if (!in[k]) continue;
    float4 row[kHit4];
    stage_box_hit(row, bs + k * kBoxCols);
    float4* dst = hb + rank[k] * kHit4;
    if (one_origin) {
      store_box_terms(dst, box_origin_terms(row, o0[0], o0[1], o0[2]), row);
    } else {
      for (int i = 0; i < kHit4; ++i) dst[i] = row[i];
    }
  }
  for (int k = threadIdx.x; k < KC; k += kThreads) {
    if (!in[KB + k]) continue;
    float4 row[kHit4];
    stage_cap_hit(row, cs + k * kCapCols);
    float4* dst = hc + rank[KB + k] * kHit4;
    if (one_origin) {
      store_cap_terms(dst, cap_origin_terms(row, o0[0], o0[1], o0[2]), row);
    } else {
      for (int i = 0; i < kHit4; ++i) dst[i] = row[i];
    }
  }
  if (REFINE)
    stage_march_rows(mb, mc, s_n, bs, KB, cs, KC, !CULL || !(n_in.x <= kb_c && n_in.y <= kc_c),
                     rank, in, n_in.x, n_in.y, kb_c, kc_c);
  __syncthreads();
  if (r0 >= R) return;  // ragged last tile

  float best[kRays], kbest[kRays];
  for (int j = 0; j < kRays; ++j) {
    best[j] = kBig;
    kbest[j] = -1.0f;
  }
  auto take = [&](int j, float tk, float id) {
    if (KID && tk < best[j]) kbest[j] = id;
    best[j] = fminf(best[j], tk);
  };
  if (one_origin) {
    for (int k = 0; k < n_in.x; ++k) {
      const float4* e = hb + k * kHit4;
      const BoxTerms bt = load_box_terms(e);
      const float cyaw = e[1].w, syaw = e[2].w;
      const float4 e3 = e[3];
      for (int j = 0; j < kRays; ++j)
        take(j, box_dir_hit(bt, cyaw, syaw, (int)e3.x, d[j][0], d[j][1], d[j][2]), e3.y);
    }
    for (int k = 0; k < n_in.y; ++k) {
      const float4* e = hc + k * kHit4;
      const CapTerms ct = load_cap_terms(e);
      if (ct.inside == 2) continue;  // the ray's own body: invisible
      const float id = e[3].w;
      for (int j = 0; j < kRays; ++j) take(j, cap_dir_hit(ct, d[j][0], d[j][1], d[j][2]), id);
    }
  } else {
    for (int k = 0; k < n_in.x; ++k) {
      const float4* row = hb + k * kHit4;
      const float cyaw = row[0].w, syaw = row[1].x;
      const float4 r2 = row[2];
      for (int j = 0; j < kRays; ++j)
        take(j, box_dir_hit(box_origin_terms(row, o[j][0], o[j][1], o[j][2]), cyaw, syaw,
                            (int)r2.y, d[j][0], d[j][1], d[j][2]), r2.z);
    }
    for (int k = 0; k < n_in.y; ++k) {
      const float4* row = hc + k * kHit4;
      const float id = row[3].y;
      for (int j = 0; j < kRays; ++j)
        take(j, cap_dir_hit(cap_origin_terms(row, o[j][0], o[j][1], o[j][2]), d[j][0], d[j][1],
                            d[j][2]), id);
    }
  }

  float t[kRays], kid[kRays];
  for (int j = 0; j < kRays; ++j) {
    kid[j] = best[j] < max_depth ? kbest[j] : -1.0f;
    t[j] = fminf(best[j], max_depth);
    if (REFINE) {
      const int n_box = s_n[0], n_static = s_n[1], n_dyn = s_n[2];
      t[j] = march_rows<false>(mb, n_box, mc, n_static, mc + (KC - n_dyn) * kCap4, n_dyn,
                               o[j][0], o[j][1], o[j][2], d[j][0], d[j][1], d[j][2], t[j],
                               n_refine, max_depth, eps, 1.0f, 0.0f);
    } else {
      t[j] = fminf(fmaxf(t[j], 0.0f), max_depth);
    }
  }
  if (vec) {
    *reinterpret_cast<float4*>(t_out + idx0) = make_float4(t[0], t[1], t[2], t[3]);
    *reinterpret_cast<uchar4*>(hit_out + idx0) =
        make_uchar4(t[0] < max_depth, t[1] < max_depth, t[2] < max_depth, t[3] < max_depth);
    if (KID)
      *reinterpret_cast<float4*>(kid_out + idx0) = make_float4(kid[0], kid[1], kid[2], kid[3]);
  } else {
    for (int j = 0; j < kRays; ++j) {
      if (r0 + j >= R) break;
      t_out[idx0 + j] = t[j];
      hit_out[idx0 + j] = t[j] < max_depth;
      if (KID) kid_out[idx0 + j] = kid[j];
    }
  }
}

}  // namespace

// Shared memory one block takes, in bytes: the rows as in device memory (13
// floats a box, 9 a capsule), the closed-form rows (16 floats a row), with
// the refine the march's rows (12 floats a box, 8 a capsule), two ints a row
// for the rank, and at most 2 KB of static scratch (TileCull and the rest).
// The wrapper checks a scene against it before it launches; the launch
// refuses more than 48 KB.
constexpr int kStaticSmem = 2048;

static int dynamic_smem(int KB, int KC, int refine) {
  return (raw_float4(KB, KC) + (KB + KC) * kHit4 + (refine ? KB * kBox4 + KC * kCap4 : 0)) *
             (int)sizeof(float4) +
         (KB + KC) * 2 * (int)sizeof(int);
}

extern "C" int trace_analytic_smem(int KB, int KC, int refine) {
  return dynamic_smem(KB, KC, refine) + kStaticSmem;
}

static bool aligned(const void* p, uintptr_t to) { return (uintptr_t)p % to == 0; }

// kid_out == nullptr selects the kernels without the id; n_refine == 0 those
// without the refine; cull != 0 culls each tile (R a multiple of 1,024) with
// capacities kb_c, kc_c, and img_w > 0 (a divisor of 1,024) says the rays are
// images of a camera img_w rays wide, whose frustum planes the cull takes.
// Returns the CUDA error of the launch; cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int trace_analytic_launch(const float* boxes, const float* caps,
                                     const float* origins, const float* dirs,
                                     float* t_out, bool* hit_out, float* kid_out,
                                     int S, int R, int KB, int KC, int kb_c, int kc_c,
                                     int img_w, float max_depth, int n_refine, float eps,
                                     int cull, cudaStream_t stream) {
  const int refine = n_refine > 0;
  if ((cull && R % kTile != 0) || (img_w > 0 && kTile % img_w != 0) ||
      trace_analytic_smem(KB, KC, refine) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores of four rays need R % 4 == 0 and aligned planes
  const int vec = R % 4 == 0 && aligned(origins, 16) && aligned(dirs, 16) &&
                  aligned(t_out, 16) && aligned(hit_out, 4) &&
                  (kid_out == nullptr || aligned(kid_out, 16));
  const dim3 grid((R + kTile - 1) / kTile, S);
  const size_t smem = dynamic_smem(KB, KC, refine);
#define VF_LAUNCH(KID, REFINE, CULL)                                                       \
  trace_analytic_kernel<KID, REFINE, CULL><<<grid, kThreads, smem, stream>>>(              \
      boxes, caps, origins, dirs, t_out, hit_out, kid_out, S, R, KB, KC, kb_c, kc_c, img_w, \
      max_depth, n_refine, eps, vec)
#define VF_LAUNCH_CULL(KID, REFINE) \
  if (cull) VF_LAUNCH(KID, REFINE, true); else VF_LAUNCH(KID, REFINE, false)
  if (kid_out != nullptr) {
    if (refine) { VF_LAUNCH_CULL(true, true); } else { VF_LAUNCH_CULL(true, false); }
  } else {
    if (refine) { VF_LAUNCH_CULL(false, true); } else { VF_LAUNCH_CULL(false, false); }
  }
#undef VF_LAUNCH_CULL
#undef VF_LAUNCH
  return (int)cudaGetLastError();
}
