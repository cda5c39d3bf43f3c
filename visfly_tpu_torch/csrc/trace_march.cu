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
// render/trace_kernel.py::cull_rows): the block reduces its tile's origin
// and direction bounds and, with img_w > 0, forms the four frustum planes;
// then it tests every row, one a thread, with the plain version's formulas
// in its order, ranks the rows in stable order (culled-in first) with a
// ballot scan, and stages the first kb_c box and kc_c capsule rows of that
// order where both counts fit, else every row. The culled-out filler rows
// are part of the function. cnt_out, where given, receives each tile's
// (nb, nc).
//
// The evaluation that stops a march early is at the t the residual
// evaluation would take, so its distance is reused: t + r equals the
// residual evaluation's result bit for bit.
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

constexpr int kTile = 1024;  // rays of a tile, threads of a block
constexpr int kWarps = kTile / 32;
constexpr int kBox4 = 3;  // float4 a staged box row
constexpr int kCap4 = 2;  // float4 a staged capsule row

__device__ __forceinline__ void stage_box(float4* dst, const float* b) {
  dst[0] = make_float4(b[0], b[1], b[2], b[7]);
  dst[1] = make_float4(b[8], b[3], b[4], b[5]);
  dst[2] = make_float4(b[6], b[9], 0.0f, 0.0f);
}

__device__ __forceinline__ void stage_cap(float4* dst, const float* c) {
  const float bax = c[3] - c[0], bay = c[4] - c[1], baz = c[5] - c[2];
  dst[0] = make_float4(c[0], c[1], c[2], c[6]);
  dst[1] = make_float4(bax, bay, baz, capsule_inv_denom(bax, bay, baz));
}

__device__ __forceinline__ float staged_box_sdf(const float4* b, float px, float py, float pz) {
  const float4 b0 = b[0], b1 = b[1], b2 = b[2];
  return box_sdf_of(b0.x, b0.y, b0.z, b1.y, b1.z, b1.w, b2.x, b0.w, b1.x, b2.y, px, py, pz);
}

__device__ __forceinline__ float staged_axis_distance(const float4* c, float px, float py,
                                                      float pz) {
  const float4 c0 = c[0], c1 = c[1];
  return axis_distance(c0.x, c0.y, c0.z, c1.x, c1.y, c1.z, c1.w, px, py, pz);
}

// Scene SDF at p over the staged rows: nb boxes, ns static capsules and nd
// dynamic capsules, each of the last skipped where it holds the origin o
// (recomputed per evaluation: a per-ray flag for each of hundreds of dynamic
// rows would live in local memory).
__device__ __forceinline__ float staged_sdf(const float4* sb, int nb, const float4* ss, int ns,
                                            const float4* sd, int nd, float px, float py,
                                            float pz, float ox, float oy, float oz) {
  float dist = kBig;
  for (int k = 0; k < nb; ++k) dist = fminf(dist, staged_box_sdf(sb + k * kBox4, px, py, pz));
  for (int k = 0; k < ns; ++k) {
    const float4* c = ss + k * kCap4;
    dist = fminf(dist, staged_axis_distance(c, px, py, pz) - c[0].w);
  }
  for (int k = 0; k < nd; ++k) {
    const float4* c = sd + k * kCap4;
    if (staged_axis_distance(c, ox, oy, oz) <= c[0].w + 0.05f) continue;
    dist = fminf(dist, staged_axis_distance(c, px, py, pz) - c[0].w);
  }
  return dist;
}

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

// For each row k < K, the number of rows before it for which pred holds:
// before[k]; returns the count over all K rows. Every thread of the block
// calls it with the same K; it synchronises the block.
template <class Pred>
__device__ int block_scan(int K, Pred pred, int* before, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int offset = 0;
  for (int base = 0; base < K; base += kTile) {
    const int k = base + threadIdx.x;
    const bool f = k < K && pred(k);
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_sum[warp] = __popc(m);
    __syncthreads();
    int pre = offset + __popc(m & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_sum[w];
      pre += w < warp ? n : 0;
      total += n;
    }
    if (k < K) before[k] = pre;
    offset += total;
    __syncthreads();
  }
  return offset;
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
  __shared__ float s_red[kWarps][12];
  __shared__ float s_lo[3], s_hi[3], s_apex[3];
  __shared__ float4 s_plane[4];  // n, |n|
  __shared__ int s_warp[kWarps];
  __shared__ int s_n[3];  // staged boxes, static capsules, dynamic capsules

  const int s = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const float* bs = boxes + (size_t)s * KB * kBoxCols;
  const float* cs = caps + (size_t)s * KC * kCapCols;
  const size_t plane = (size_t)S * R;
  const size_t row0 = (size_t)s * R + tile0;
  if (threadIdx.x < 3) s_n[threadIdx.x] = 0;

  bool fits = true;
  int nb = 0, nc = 0;  // culled-in rows of each family
  if (CULL) {
    // the tile's reachable box: o.min + max_depth*min(d.min, 0) .. o.max + max_depth*max(d.max, 0)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float mn[6], mx[6];
    for (int c = 0; c < 3; ++c) {
      const float o = origins[c * plane + row0 + threadIdx.x];
      const float d = dirs[c * plane + row0 + threadIdx.x];
      mn[c] = mx[c] = o;
      mn[3 + c] = mx[3 + c] = d;
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int c = 0; c < 6; ++c) {
        mn[c] = fminf(mn[c], __shfl_xor_sync(0xffffffffu, mn[c], off));
        mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], off));
      }
    }
    if (lane == 0) {
      for (int c = 0; c < 6; ++c) {
        s_red[warp][c] = mn[c];
        s_red[warp][6 + c] = mx[c];
      }
    }
    // the frustum planes through consecutive corner rays, turned to face the
    // centre ray, and the apex at the tile's first origin
    const int p = threadIdx.x - 32;
    if (img_w > 0 && p >= 0 && p < 4) {
      const int corner[4] = {0, img_w - 1, kTile - 1, kTile - img_w};
      float a[3], b[3], ctr[3];
      for (int c = 0; c < 3; ++c) {
        const float* dc = dirs + c * plane + row0;
        a[c] = dc[corner[p]];
        b[c] = dc[corner[(p + 1) & 3]];
        ctr[c] = dc[corner[0]] + dc[corner[1]] + dc[corner[2]] + dc[corner[3]];
      }
      float n0 = a[1] * b[2] - a[2] * b[1];
      float n1 = a[2] * b[0] - a[0] * b[2];
      float n2 = a[0] * b[1] - a[1] * b[0];
      const float f = n0 * ctr[0] + n1 * ctr[1] + n2 * ctr[2] < 0.0f ? -1.0f : 1.0f;
      n0 = n0 * f;
      n1 = n1 * f;
      n2 = n2 * f;
      s_plane[p] = make_float4(n0, n1, n2, sqrtf(n0 * n0 + n1 * n1 + n2 * n2));
      if (p == 0)
        for (int c = 0; c < 3; ++c) s_apex[c] = origins[c * plane + row0];
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      const int c = threadIdx.x;
      float omin = s_red[0][c], dmin = s_red[0][3 + c];
      float omax = s_red[0][6 + c], dmax = s_red[0][9 + c];
      for (int w = 1; w < kWarps; ++w) {
        omin = fminf(omin, s_red[w][c]);
        dmin = fminf(dmin, s_red[w][3 + c]);
        omax = fmaxf(omax, s_red[w][6 + c]);
        dmax = fmaxf(dmax, s_red[w][9 + c]);
      }
      s_lo[c] = omin + max_depth * fminf(dmin, 0.0f);
      s_hi[c] = omax + max_depth * fmaxf(dmax, 0.0f);
    }
    __syncthreads();

    // which rows meet the tile: active rows whose bounds overlap the reachable
    // box and lie on the inner side of every plane; hollow rooms always
    auto box_in = [&](int k) {
      const float* b = bs + k * kBoxCols;
      if (!(b[11] > 0.5f)) return false;
      if (b[9] < 0.0f) return true;
      const float acy = fabsf(b[7]), asy = fabsf(b[8]);
      const float hw[3] = {acy * b[3] + asy * b[4] + b[6], asy * b[3] + acy * b[4] + b[6],
                           b[5] + b[6]};
      for (int c = 0; c < 3; ++c)
        if (!(s_lo[c] <= b[c] + hw[c] && s_hi[c] >= b[c] - hw[c])) return false;
      if (img_w > 0) {
        for (int q = 0; q < 4; ++q) {
          const float4 n = s_plane[q];
          const float dist = n.x * (b[0] - s_apex[0]) + n.y * (b[1] - s_apex[1]) +
                             n.z * (b[2] - s_apex[2]);
          const float r = fabsf(n.x) * hw[0] + fabsf(n.y) * hw[1] + fabsf(n.z) * hw[2];
          if (!(dist + r >= 0.0f)) return false;
        }
      }
      return true;
    };
    auto cap_in = [&](int k) {
      const float* c = cs + k * kCapCols;
      if (!(c[7] > 0.5f)) return false;
      for (int i = 0; i < 3; ++i)
        if (!(s_lo[i] <= fmaxf(c[i], c[3 + i]) + c[6] && s_hi[i] >= fminf(c[i], c[3 + i]) - c[6]))
          return false;
      if (img_w > 0) {
        for (int q = 0; q < 4; ++q) {
          const float4 n = s_plane[q];
          const float da = n.x * (c[0] - s_apex[0]) + n.y * (c[1] - s_apex[1]) +
                           n.z * (c[2] - s_apex[2]);
          const float db = n.x * (c[3] - s_apex[0]) + n.y * (c[4] - s_apex[1]) +
                           n.z * (c[5] - s_apex[2]);
          if (!(fmaxf(da, db) + c[6] * n.w >= 0.0f)) return false;
        }
      }
      return true;
    };
    nb = block_scan(KB, [&](int k) { return (bool)(in[k] = box_in(k)); }, rank, s_warp);
    nc = block_scan(
        KC, [&](int k) { return (bool)(in[KB + k] = cap_in(k)); }, rank + KB, s_warp);
    fits = nb <= kb_c && nc <= kc_c;
    if (cnt_out != nullptr && threadIdx.x == 0) {
      const size_t tile = (size_t)s * gridDim.x + blockIdx.x;
      cnt_out[2 * tile] = nb;
      cnt_out[2 * tile + 1] = nc;
    }
  } else {
    __syncthreads();  // s_n
  }

  // row k of a family with n culled-in rows is evaluated where the tile does
  // not fit, or where its place in the stable order is below the capacity
  auto evaluated = [&](int k, int first, int n, int cap) {
    if (!CULL || !fits) return true;
    const int ahead = rank[first + k];
    return (in[first + k] ? ahead : n + k - ahead) < cap;
  };
  for (int k = threadIdx.x; k < KB; k += kTile) {
    const float* b = bs + k * kBoxCols;
    if (b[11] > 0.5f && evaluated(k, 0, nb, kb_c))
      stage_box(sb + atomicAdd(&s_n[0], 1) * kBox4, b);
  }
  for (int k = threadIdx.x; k < KC; k += kTile) {
    const float* c = cs + k * kCapCols;
    if (!(c[7] > 0.5f) || !evaluated(k, KB, nc, kc_c)) continue;
    if (c[7] > 1.5f)
      stage_cap(sc + (KC - 1 - atomicAdd(&s_n[2], 1)) * kCap4, c);
    else
      stage_cap(sc + atomicAdd(&s_n[1], 1) * kCap4, c);
  }
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
  float t = t_init != nullptr ? t_init[idx] : 0.0f;
  float prev_r = 0.0f, step_len = 0.0f, om = omega;
  for (int i = 0;; ++i) {
    const float dist = staged_sdf(sb, n_box, sc, n_static, sd, n_dyn, ox + dx * t,
                                  oy + dy * t, oz + dz * t, ox, oy, oz);
    if (i == n_steps) {  // the residual evaluation
      t = t + dist;
      break;
    }
    if (!RELAXED) {
      if (dist < eps || t >= max_depth) {  // t + dist is the residual evaluation's
        t = t + dist;
        break;
      }
      t = t + dist;
    } else {
      const bool fail = om > 1.0f && (dist + prev_r < step_len);
      if ((!fail && dist < eps) || t >= max_depth) {
        t = t + dist;
        break;
      }
      const float new_step = fail ? step_len * one_minus_omega : dist * om;
      if (fail) om = 1.0f;
      t = t + new_step;
      prev_r = dist;
      step_len = new_step;
    }
  }
  t = fminf(fmaxf(t, 0.0f), max_depth);
  t_out[idx] = t;
  hit_out[idx] = t < max_depth;
}

}  // namespace

// Shared memory one block takes, in bytes: the staged rows (12 floats a box,
// 8 a capsule), for the cull two ints a row, and at most 2 KB of static
// scratch (s_red and the rest). The wrapper checks a scene against it before
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
