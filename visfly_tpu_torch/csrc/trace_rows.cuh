// What the ray-trace kernels (trace_analytic.cu, trace_march.cu) share: the
// counterpart of the tile body that all modes of the TPU kernel share,
// visfly_tpu/render/pallas_trace.py::_trace_tile, and of its per-tile cull,
// cull_compact.
//   - the march's staged float4 rows and the one march over them
//     (stage_march_rows, staged_sdf, march_rows);
//   - the per-tile cull: the tile's reachable box and frustum planes
//     (tile_reach), each row's test in the plain version's order and the
//     stable rank of the rows that pass (rank_rows), and the rows the TPU
//     tile evaluates, filler rows included (tile_evaluates);
//   - the closed-form first hit of a box and of a capsule, split into the
//     terms of the ray's origin (box_origin_terms, cap_origin_terms), which a
//     tile whose rays share one origin forms once a row, and the rest, which
//     every ray forms (box_dir_hit, cap_dir_hit).
//
// Row layouts in device memory:
//   boxes    (S, KB, 13) [cx cy cz hx hy hz r cos sin sign family active id]
//   capsules (S, KC, 9)  [ax ay az bx by bz r active id]
// A capsule with active == 2 is a dynamic object (an agent's body): a ray
// whose origin lies within r + 0.05 of it ignores it, in every mode.
//
// Every function keeps the operation order of the plain PyTorch version in
// render/trace_kernel.py; the sources build with --fmad=false and without
// --use_fast_math, so each operation rounds as it does there.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace vf {

constexpr int kBoxCols = 13;
constexpr int kCapCols = 9;
constexpr int kTile = 1024;  // rays of a tile, the TPU kernel's (8, 128) block
constexpr int kMaxWarps = kTile / 32;
constexpr int kBox4 = 3;  // float4 a staged march box row
constexpr int kCap4 = 2;  // float4 a staged march capsule row
constexpr float kBig = 1e9f;

// ---------------------------------------------------------------------------
// signed distance of one row
// ---------------------------------------------------------------------------

// Signed distance of the box of centre c, half sizes h, rounding radius rad,
// yaw (cos, sin) and sign (−1: a hollow room).
__device__ __forceinline__ float box_sdf_of(float cx, float cy, float cz, float hx, float hy,
                                            float hz, float rad, float cyaw, float syaw,
                                            float sign, float px, float py, float pz) {
  const float rx = px - cx, ry = py - cy;
  const float x = cyaw * rx + syaw * ry;
  const float y = -syaw * rx + cyaw * ry;
  const float z = pz - cz;
  const float qx = fabsf(x) - hx, qy = fabsf(y) - hy, qz = fabsf(z) - hz;
  const float ex = fmaxf(qx, 0.0f), ey = fmaxf(qy, 0.0f), ez = fmaxf(qz, 0.0f);
  const float outside = sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f);
  const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
  return (outside + inside - rad) * sign;
}

// 1 / (ba·ba + 1e-9) of a capsule's axis ba: a row constant, staged once a
// tile.
__device__ __forceinline__ float capsule_inv_denom(float bax, float bay, float baz) {
  return 1.0f / (bax * bax + bay * bay + baz * baz + 1e-9f);
}

// Distance from p to the axis segment from a along ba.
__device__ __forceinline__ float axis_distance(float ax, float ay, float az, float bax,
                                               float bay, float baz, float inv_denom,
                                               float px, float py, float pz) {
  const float pax = px - ax, pay = py - ay, paz = pz - az;
  const float h = fminf(fmaxf((pax * bax + pay * bay + paz * baz) * inv_denom, 0.0f), 1.0f);
  const float ex = pax - bax * h, ey = pay - bay * h, ez = paz - baz * h;
  return sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f);
}

// ---------------------------------------------------------------------------
// the march: staged rows, the scene SDF over them, and the march itself
// ---------------------------------------------------------------------------

// A box as 3 float4 [cx cy cz cos] [sin hx hy hz] [r sign - -]; a capsule as
// 2 float4 [ax ay az r] [bax bay baz 1/(ba.ba + 1e-9)].
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

// The march of one ray from t over the staged rows → clamp(t, 0, max_depth):
// n_steps of t += sdf(o + t*d) while sdf >= eps and t < max_depth, then the
// residual evaluation t + sdf. The evaluation that stops a march early is at
// the t the residual evaluation would take, so its distance is reused: t +
// dist equals the residual evaluation's result bit for bit. RELAXED
// over-relaxes the step by omega with the safeguard of Keinert et al.: when
// the safe spheres of two consecutive samples stop overlapping the ray steps
// back inside the previous one (one_minus_omega: 1 - omega rounded once by
// the caller) and marches plainly from then on.
template <bool RELAXED>
__device__ __forceinline__ float march_rows(const float4* sb, int nb, const float4* ss, int ns,
                                            const float4* sd, int nd, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float t,
                                            int n_steps, float max_depth, float eps,
                                            float omega, float one_minus_omega) {
  float prev_r = 0.0f, step_len = 0.0f, om = omega;
  for (int i = 0;; ++i) {
    const float dist = staged_sdf(sb, nb, ss, ns, sd, nd, ox + dx * t, oy + dy * t, oz + dz * t,
                                  ox, oy, oz);
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
  return fminf(fmaxf(t, 0.0f), max_depth);
}

// ---------------------------------------------------------------------------
// the per-tile cull (plain version: render/trace_kernel.py::cull_rows)
// ---------------------------------------------------------------------------

// A block's cull state: the tile's reachable box lo..hi and, with img_w > 0,
// the four frustum planes (n, |n|) through their apex, the tile's first
// origin.
struct TileCull {
  float red[kMaxWarps][12];
  float lo[3], hi[3], apex[3];
  float corner[4][3];  // corner rays' directions, where a kernel stages them
  float4 plane[4];
  int warp_sum[kMaxWarps][2];
};

// The tile's ray at corner q of a camera img_w rays wide: 0, img_w − 1,
// 1023, 1024 − img_w.
__device__ __forceinline__ int corner_ray(int q, int img_w) {
  return q == 0 ? 0 : q == 1 ? img_w - 1 : q == 2 ? kTile - 1 : kTile - img_w;
}

// A float's key in the order of ints (-0 below +0), for the warps' integer
// minimum and maximum, and back.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The tile's reachable box, o.min + max_depth*min(d.min, 0) .. o.max +
// max_depth*max(d.max, 0), from each thread's bounds of the rays it holds
// (mn, mx: ox oy oz dx dy dz), and with img_w > 0 the frustum planes through
// consecutive corner rays (corner_ray; dir(q, c): component c of corner q's
// direction) with their apex at the tile's first origin (apex(c)), turned
// to face the centre ray. Every thread of the block calls it; it
// synchronises the block. The bounds reduce as order keys, one integer
// reduction a warp each: minima and maxima are exact, so the order of the
// reduction changes no bit (a -0 for a +0 changes no comparison the cull
// makes).
template <class Dir, class Apex>
__device__ __forceinline__ void tile_reach(TileCull& tc, float* mn, float* mx, Dir dir,
                                           Apex apex, float max_depth, int img_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = threadIdx.x - 32;
  if (img_w > 0 && p >= 0 && p < 4) {
    float a[3], b[3], ctr[3];
    for (int c = 0; c < 3; ++c) {
      a[c] = dir(p, c);
      b[c] = dir((p + 1) & 3, c);
      ctr[c] = dir(0, c) + dir(1, c) + dir(2, c) + dir(3, c);
    }
    float n0 = a[1] * b[2] - a[2] * b[1];
    float n1 = a[2] * b[0] - a[0] * b[2];
    float n2 = a[0] * b[1] - a[1] * b[0];
    const float f = n0 * ctr[0] + n1 * ctr[1] + n2 * ctr[2] < 0.0f ? -1.0f : 1.0f;
    n0 = n0 * f;
    n1 = n1 * f;
    n2 = n2 * f;
    tc.plane[p] = make_float4(n0, n1, n2, sqrtf(n0 * n0 + n1 * n1 + n2 * n2));
    if (p == 0)
      for (int c = 0; c < 3; ++c) tc.apex[c] = apex(c);
  }
  for (int c = 0; c < 6; ++c) {
    const int lo = __reduce_min_sync(0xffffffffu, order_key(mn[c]));
    const int hi = __reduce_max_sync(0xffffffffu, order_key(mx[c]));
    if (lane == 0) {
      tc.red[warp][c] = from_order_key(lo);
      tc.red[warp][6 + c] = from_order_key(hi);
    }
  }
  __syncthreads();
  if (warp == 0) {  // the warps' bounds, one a lane
    const bool has = lane < (int)(blockDim.x >> 5);
    float v[12];
    for (int c = 0; c < 6; ++c) {
      const int lo = __reduce_min_sync(0xffffffffu, has ? order_key(tc.red[lane][c]) : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu,
                                       has ? order_key(tc.red[lane][6 + c]) : INT_MIN);
      v[c] = from_order_key(lo);
      v[6 + c] = from_order_key(hi);
    }
    if (lane == 0) {
      for (int c = 0; c < 3; ++c) {
        tc.lo[c] = v[c] + max_depth * fminf(v[3 + c], 0.0f);
        tc.hi[c] = v[6 + c] + max_depth * fmaxf(v[9 + c], 0.0f);
      }
    }
  }
  __syncthreads();
}

// Whether a box row meets the tile: active, and a hollow room or bounds that
// overlap the reachable box and lie on the inner side of every plane.
__device__ __forceinline__ bool box_meets_tile(const TileCull& tc, const float* b, int img_w) {
  if (!(b[11] > 0.5f)) return false;
  if (b[9] < 0.0f) return true;
  const float acy = fabsf(b[7]), asy = fabsf(b[8]);
  const float hw[3] = {acy * b[3] + asy * b[4] + b[6], asy * b[3] + acy * b[4] + b[6],
                       b[5] + b[6]};
  for (int c = 0; c < 3; ++c)
    if (!(tc.lo[c] <= b[c] + hw[c] && tc.hi[c] >= b[c] - hw[c])) return false;
  if (img_w > 0) {
    for (int q = 0; q < 4; ++q) {
      const float4 n = tc.plane[q];
      const float dist = n.x * (b[0] - tc.apex[0]) + n.y * (b[1] - tc.apex[1]) +
                         n.z * (b[2] - tc.apex[2]);
      const float r = fabsf(n.x) * hw[0] + fabsf(n.y) * hw[1] + fabsf(n.z) * hw[2];
      if (!(dist + r >= 0.0f)) return false;
    }
  }
  return true;
}

// Whether a capsule row meets the tile: active, its endpoints' box grown by r
// overlapping the reachable box, and on the inner side of every plane.
__device__ __forceinline__ bool cap_meets_tile(const TileCull& tc, const float* c, int img_w) {
  if (!(c[7] > 0.5f)) return false;
  for (int i = 0; i < 3; ++i)
    if (!(tc.lo[i] <= fmaxf(c[i], c[3 + i]) + c[6] && tc.hi[i] >= fminf(c[i], c[3 + i]) - c[6]))
      return false;
  if (img_w > 0) {
    for (int q = 0; q < 4; ++q) {
      const float4 n = tc.plane[q];
      const float da = n.x * (c[0] - tc.apex[0]) + n.y * (c[1] - tc.apex[1]) +
                       n.z * (c[2] - tc.apex[2]);
      const float db = n.x * (c[3] - tc.apex[0]) + n.y * (c[4] - tc.apex[1]) +
                       n.z * (c[5] - tc.apex[2]);
      if (!(fmaxf(da, db) + c[6] * n.w >= 0.0f)) return false;
    }
  }
  return true;
}

// For each row k of KB boxes and then KC capsules, the rows of its family
// before it for which pass(k) holds: rank[k]; → (nb, nc), the rows of each
// family for which it holds. One ballot a warp and family: up to 32 rows in
// one warp behind one barrier, else blockDim.x rows a round of two barriers.
// Every thread of the block calls it with the same KB, KC, once a kernel
// (the counts it returns stay in warp_sum).
template <class Pass>
__device__ int2 rank_families(int KB, int KC, Pass pass, int* rank, int (*warp_sum)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, K = KB + KC;
  const unsigned below = (1u << lane) - 1u;
  if (K <= 32) {  // one warp ranks every row, behind one barrier
    if (warp == 0) {
      const bool f = lane < K && pass(lane);
      const unsigned mb = __ballot_sync(0xffffffffu, f && lane < KB);
      const unsigned mc = __ballot_sync(0xffffffffu, f && lane >= KB);
      if (lane < K) rank[lane] = __popc((lane < KB ? mb : mc) & below);
      if (lane == 0) {
        warp_sum[0][0] = __popc(mb);
        warp_sum[0][1] = __popc(mc);
      }
    }
    __syncthreads();
    return make_int2(warp_sum[0][0], warp_sum[0][1]);
  }
  int nb = 0, nc = 0;
  for (int base = 0; base < K; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const bool f = k < K && pass(k);
    const unsigned mb = __ballot_sync(0xffffffffu, f && k < KB);
    const unsigned mc = __ballot_sync(0xffffffffu, f && k >= KB);
    if (lane == 0) {
      warp_sum[warp][0] = __popc(mb);
      warp_sum[warp][1] = __popc(mc);
    }
    __syncthreads();
    int pb = nb + __popc(mb & below), pc = nc + __popc(mc & below);
    for (int w = 0; w < n_warps; ++w) {
      const int b = warp_sum[w][0], c = warp_sum[w][1];
      pb += w < warp ? b : 0;
      pc += w < warp ? c : 0;
      nb += b;
      nc += c;
    }
    if (k < K) rank[k] = k < KB ? pb : pc;
    __syncthreads();
  }
  return make_int2(nb, nc);
}

// Tests every row of one scene (bs, cs: its rows, in device or shared
// memory), boxes then capsules, in[k] for row k of KB + KC: with CULL
// whether it meets the tile (tile_reach first), else whether it is active;
// rank[k]: the rows of its family ahead of it that pass. → (nb, nc), the
// rows of each family that pass.
template <bool CULL>
__device__ __forceinline__ int2 rank_rows(TileCull& tc, const float* bs, int KB, const float* cs,
                                          int KC, int img_w, int* rank, int* in) {
  return rank_families(KB, KC, [&](int k) {
    bool f;
    if (k < KB) {
      const float* b = bs + k * kBoxCols;
      f = CULL ? box_meets_tile(tc, b, img_w) : b[11] > 0.5f;
    } else {
      const float* c = cs + (k - KB) * kCapCols;
      f = CULL ? cap_meets_tile(tc, c, img_w) : c[7] > 0.5f;
    }
    in[k] = f;
    return f;
  }, rank, tc.warp_sum);
}

// Whether the TPU tile evaluates row k of a family (first: its offset in
// rank and in; n rows of the family meet the tile; cap: the compacted
// block's capacity): the first cap rows of the stable order that puts the
// culled-in rows first, the rest being filler rows.
__device__ __forceinline__ bool tile_evaluates(const int* rank, const int* in, int k, int first,
                                               int n, int cap) {
  const int ahead = rank[first + k];
  return (in[first + k] ? ahead : n + k - ahead) < cap;
}

// Stages the active rows of one scene that the tile evaluates (all of them
// where every_row, else those of tile_evaluates) for the march, in any
// order: boxes at sb, static capsules from the front of sc, dynamic ones
// from its end (KC rows). n[3] (zeroed by the caller) receives the staged
// boxes, static and dynamic capsules; the caller synchronises the block.
__device__ __forceinline__ void stage_march_rows(float4* sb, float4* sc, int* n,
                                                 const float* bs, int KB, const float* cs,
                                                 int KC, bool every_row, const int* rank,
                                                 const int* in, int nb, int nc, int kb_c,
                                                 int kc_c) {
  for (int k = threadIdx.x; k < KB; k += blockDim.x) {
    const float* b = bs + k * kBoxCols;
    if (b[11] > 0.5f && (every_row || tile_evaluates(rank, in, k, 0, nb, kb_c)))
      stage_box(sb + atomicAdd(&n[0], 1) * kBox4, b);
  }
  for (int k = threadIdx.x; k < KC; k += blockDim.x) {
    const float* c = cs + k * kCapCols;
    if (!(c[7] > 0.5f) || !(every_row || tile_evaluates(rank, in, k, KB, nc, kc_c))) continue;
    if (c[7] > 1.5f)
      stage_cap(sc + (KC - 1 - atomicAdd(&n[2], 1)) * kCap4, c);
    else
      stage_cap(sc + atomicAdd(&n[1], 1) * kCap4, c);
  }
}

// ---------------------------------------------------------------------------
// closed-form first hit of one row, split at the ray's origin
// ---------------------------------------------------------------------------

constexpr int kHit4 = 4;  // float4 a staged closed-form row, or its origin terms
enum : int { kSolid = 0, kSphere = 1, kRoom = 2 };  // a box row's closed form

// A box for the closed form: [cx cy cz cos] [sin hx+r hy+r hz+r] [r kind id -].
__device__ __forceinline__ void stage_box_hit(float4* dst, const float* b) {
  const float kind = b[9] < 0.0f ? kRoom : (b[3] + b[4] + b[5] < 1e-6f ? kSphere : kSolid);
  dst[0] = make_float4(b[0], b[1], b[2], b[7]);
  dst[1] = make_float4(b[8], b[3] + b[6], b[4] + b[6], b[5] + b[6]);
  dst[2] = make_float4(b[6], kind, b[12], 0.0f);
}

// The origin's terms of a box: the origin p in the box's frame, the slab
// numerators lo = −h' − p and hi = h' − p (h' = h + r), and the sphere's
// cs = p·p − r².
struct BoxTerms {
  float px, py, pz, cs, lx, ly, lz, ux, uy, uz;
};

__device__ __forceinline__ BoxTerms box_origin_terms(const float4* row, float ox, float oy,
                                                     float oz) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2];
  const float rx = ox - r0.x, ry = oy - r0.y;
  BoxTerms t;
  t.px = r0.w * rx + r1.x * ry;
  t.py = -r1.x * rx + r0.w * ry;
  t.pz = oz - r0.z;
  t.cs = t.px * t.px + t.py * t.py + t.pz * t.pz - r2.x * r2.x;
  t.lx = -r1.y - t.px;
  t.ly = -r1.z - t.py;
  t.lz = -r1.w - t.pz;
  t.ux = r1.y - t.px;
  t.uy = r1.z - t.py;
  t.uz = r1.w - t.pz;
  return t;
}

// A box's terms as 4 float4 [px py pz cs] [lx ly lz cos] [ux uy uz sin]
// [kind id - -], from its staged row.
__device__ __forceinline__ void store_box_terms(float4* dst, const BoxTerms& t,
                                                const float4* row) {
  dst[0] = make_float4(t.px, t.py, t.pz, t.cs);
  dst[1] = make_float4(t.lx, t.ly, t.lz, row[0].w);
  dst[2] = make_float4(t.ux, t.uy, t.uz, row[1].x);
  dst[3] = make_float4(row[2].y, row[2].z, 0.0f, 0.0f);
}

__device__ __forceinline__ BoxTerms load_box_terms(const float4* src) {
  const float4 a = src[0], b = src[1], c = src[2];
  return BoxTerms{a.x, a.y, a.z, a.w, b.x, b.y, b.z, c.x, c.y, c.z};
}

// v, or ±1e-9 where |v| < 1e-9: the slab test's divisor.
__device__ __forceinline__ float safe_divisor(float v) {
  return fabsf(v) < 1e-9f ? (v >= 0.0f ? 1e-9f : -1e-9f) : v;
}

// Entry and exit t of the slab lo <= t*v <= hi.
__device__ __forceinline__ void slab(float lo, float hi, float v, float& tn, float& tf) {
  const float t1 = lo / safe_divisor(v);
  const float t2 = hi / safe_divisor(v);
  tn = fminf(t1, t2);
  tf = fmaxf(t1, t2);
}

// First hit along d of the box whose origin terms are t, of yaw (cos, sin):
// the slab test of the radius-inflated box, the slab exit for a hollow room,
// the quadratic for a sphere (half sizes 0).
__device__ __forceinline__ float box_dir_hit(const BoxTerms& t, float cyaw, float syaw,
                                             int kind, float dx, float dy, float dz) {
  const float vx = cyaw * dx + syaw * dy;
  const float vy = -syaw * dx + cyaw * dy;
  const float vz = dz;
  if (kind == kSphere) {
    const float bs = t.px * vx + t.py * vy + t.pz * vz;
    const float disc = bs * bs - t.cs;
    if (!(disc > 0.0f)) return kBig;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float tin = -bs - sq, tout = -bs + sq;
    return tin >= 0.0f ? tin : (tout > 0.0f ? 0.0f : kBig);
  }
  float n1, f1, n2, f2, n3, f3;
  slab(t.lx, t.ux, vx, n1, f1);
  slab(t.ly, t.uy, vy, n2, f2);
  // a solid box that two slabs miss is missed: tn >= max(n1, n2), tf <= min(f1, f2)
  if (kind == kSolid && !(fmaxf(n1, n2) <= fminf(f1, f2) && fminf(f1, f2) > 0.0f)) return kBig;
  slab(t.lz, t.uz, vz, n3, f3);
  const float tn = fmaxf(n1, fmaxf(n2, n3));
  const float tf = fminf(f1, fminf(f2, f3));
  if (kind == kRoom) return tn <= 0.0f ? fmaxf(tf, 0.0f) : 0.0f;  // the exit from inside
  return (tn <= tf && tf > 0.0f) ? fmaxf(tn, 0.0f) : kBig;
}

// A capsule for the closed form: [ax ay az r] [bax bay baz 1/(ba.ba + 1e-9)]
// [bx by bz ba.ba] [dynamic id - -].
__device__ __forceinline__ void stage_cap_hit(float4* dst, const float* c) {
  const float bax = c[3] - c[0], bay = c[4] - c[1], baz = c[5] - c[2];
  dst[0] = make_float4(c[0], c[1], c[2], c[6]);
  dst[1] = make_float4(bax, bay, baz, capsule_inv_denom(bax, bay, baz));
  dst[2] = make_float4(c[3], c[4], c[5], bax * bax + bay * bay + baz * baz);
  dst[3] = make_float4(c[7] > 1.5f ? 1.0f : 0.0f, c[8], 0.0f, 0.0f);
}

// The origin's terms of a capsule: its axis ba and ba·ba, oa = o − a,
// ba·oa, the cylinder's Cq, each end sphere's o − e (o − a is oa) and
// cc = |o − e|² − r², and whether the capsule grown by 5 cm holds the
// origin (inside: 0 no, 1 a static row, hit at 0, 2 a dynamic row, which
// the ray ignores).
struct CapTerms {
  float bax, bay, baz, baba, oax, oay, oaz, baoa, Cq, cca, ccb, obx, oby, obz;
  int inside;
};

__device__ __forceinline__ CapTerms cap_origin_terms(const float4* row, float ox, float oy,
                                                     float oz) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
  const float rad = r0.w;
  CapTerms t;
  t.bax = r1.x;
  t.bay = r1.y;
  t.baz = r1.z;
  t.baba = r2.w;
  const bool holds =
      axis_distance(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, r1.w, ox, oy, oz) <= rad + 0.05f;
  t.inside = holds ? (r3.x > 0.5f ? 2 : 1) : 0;
  t.oax = ox - r0.x;
  t.oay = oy - r0.y;
  t.oaz = oz - r0.z;
  t.baoa = t.bax * t.oax + t.bay * t.oay + t.baz * t.oaz;
  const float oaoa = t.oax * t.oax + t.oay * t.oay + t.oaz * t.oaz;
  t.Cq = t.baba * oaoa - t.baoa * t.baoa - rad * rad * t.baba;
  t.cca = oaoa - rad * rad;
  t.obx = ox - r2.x;
  t.oby = oy - r2.y;
  t.obz = oz - r2.z;
  t.ccb = t.obx * t.obx + t.oby * t.oby + t.obz * t.obz - rad * rad;
  return t;
}

// A capsule's terms as 4 float4 [bax bay baz baba] [oax oay oaz baoa]
// [Cq cca ccb inside] [obx oby obz id], from its staged row.
__device__ __forceinline__ void store_cap_terms(float4* dst, const CapTerms& t,
                                                const float4* row) {
  dst[0] = make_float4(t.bax, t.bay, t.baz, t.baba);
  dst[1] = make_float4(t.oax, t.oay, t.oaz, t.baoa);
  dst[2] = make_float4(t.Cq, t.cca, t.ccb, (float)t.inside);
  dst[3] = make_float4(t.obx, t.oby, t.obz, row[3].y);
}

__device__ __forceinline__ CapTerms load_cap_terms(const float4* src) {
  const float4 a = src[0], b = src[1], c = src[2], e = src[3];
  return CapTerms{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, e.x, e.y, e.z,
                  (int)c.w};
}

// Entry t of the sphere whose ray terms are bb = (o − e)·d and
// cc = |o − e|² − r², where it lies ahead, else kBig. A ray that misses the
// sphere takes no square root (its value would not be used).
__device__ __forceinline__ float end_sphere_hit(float bb, float cc) {
  const float dd = bb * bb - cc;
  if (!(dd > 0.0f)) return kBig;
  const float ti = -bb - sqrtf(dd);
  return ti >= 0.0f ? ti : kBig;
}

// First hit along d of the capsule whose origin terms are t: the cylinder's
// quadratic between the end planes, then both end spheres. (o − a)·d is
// both the cylinder's rdoa and the first sphere's bb. A ray whose quadratic
// has no root takes no square root and no division: where hq > 0 and
// A > 1e-7, max(hq, 0) is hq and max(A, 1e-9) is A, so the bits are the
// plain version's.
__device__ __forceinline__ float cap_dir_hit(const CapTerms& t, float dx, float dy, float dz) {
  if (t.inside != 0) return t.inside == 2 ? kBig : 0.0f;
  const float bard = t.bax * dx + t.bay * dy + t.baz * dz;
  const float rdoa = dx * t.oax + dy * t.oay + dz * t.oaz;
  const float A = t.baba - bard * bard;
  const float Bq = t.baba * rdoa - t.baoa * bard;
  const float hq = Bq * Bq - A * t.Cq;
  float tk = kBig;
  if (hq > 0.0f && A > 1e-7f) {
    const float tcyl = (-Bq - sqrtf(hq)) / A;
    const float yc = t.baoa + tcyl * bard;
    if (yc >= 0.0f && yc <= t.baba && tcyl >= 0.0f) tk = tcyl;
  }
  tk = fminf(tk, end_sphere_hit(rdoa, t.cca));
  tk = fminf(tk, end_sphere_hit(t.obx * dx + t.oby * dy + t.obz * dz, t.ccb));
  return tk;
}

}  // namespace vf
