// Per-row arithmetic shared by the ray-trace kernels (trace_analytic.cu,
// trace_march.cu): the closed-form first hit of one packed scene row, the
// signed distance of one row (box_sdf_of, axis_distance: the forms both
// kernels' row layouts call), and the scene SDF the analytic refine marches.
// It is the counterpart of the one tile body that all modes of the TPU
// kernel share, visfly_tpu/render/pallas_trace.py::_trace_tile.
//
// Row layouts:
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

namespace vf {

constexpr int kBoxCols = 13;
constexpr int kCapCols = 9;
constexpr int kThreads = 256;
constexpr float kBig = 1e9f;

// Copies scene s's rows into shared memory: boxes first, capsules after.
// The caller synchronises the block.
__device__ __forceinline__ void stage_rows(float* rows, const float* __restrict__ boxes,
                                           const float* __restrict__ caps, int s, int KB,
                                           int KC) {
  float* sb = rows;
  float* sc = rows + KB * kBoxCols;
  for (int i = threadIdx.x; i < KB * kBoxCols; i += blockDim.x)
    sb[i] = boxes[(size_t)s * KB * kBoxCols + i];
  for (int i = threadIdx.x; i < KC * kCapCols; i += blockDim.x)
    sc[i] = caps[(size_t)s * KC * kCapCols + i];
}

// ---------------------------------------------------------------------------
// closed-form first hit of one row
// ---------------------------------------------------------------------------

// Entry and exit t of the slab |p + t*v| <= h.
__device__ __forceinline__ void slab(float p, float v, float h, float& tn, float& tf) {
  const float safe = fabsf(v) < 1e-9f ? (v >= 0.0f ? 1e-9f : -1e-9f) : v;
  const float t1 = (-h - p) / safe;
  const float t2 = (h - p) / safe;
  tn = fminf(t1, t2);
  tf = fmaxf(t1, t2);
}

// Entry and exit t of the box of half sizes (hx, hy, hz).
__device__ __forceinline__ void box_span(float px, float py, float pz, float vx, float vy,
                                         float vz, float hx, float hy, float hz,
                                         float& tn, float& tf) {
  float n1, f1, n2, f2, n3, f3;
  slab(px, vx, hx, n1, f1);
  slab(py, vy, hy, n2, f2);
  slab(pz, vz, hz, n3, f3);
  tn = fmaxf(n1, fmaxf(n2, n3));
  tf = fminf(f1, fminf(f2, f3));
}

__device__ __forceinline__ float box_hit(const float* b, float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  const float cyaw = b[7], syaw = b[8];
  const float rx = ox - b[0], ry = oy - b[1];
  const float px = cyaw * rx + syaw * ry;
  const float py = -syaw * rx + cyaw * ry;
  const float pz = oz - b[2];
  const float vx = cyaw * dx + syaw * dy;
  const float vy = -syaw * dx + cyaw * dy;
  const float vz = dz;
  const float hx = b[3], hy = b[4], hz = b[5], rad = b[6];

  float tn, tf;
  if (b[9] < 0.0f) {  // hollow room: the exit of the inflated box from inside
    box_span(px, py, pz, vx, vy, vz, hx + rad, hy + rad, hz + rad, tn, tf);
    return tn <= 0.0f ? fmaxf(tf, 0.0f) : 0.0f;
  }
  if (hx + hy + hz < 1e-6f) {  // sphere
    const float bs = px * vx + py * vy + pz * vz;
    const float cs = px * px + py * py + pz * pz - rad * rad;
    const float disc = bs * bs - cs;
    if (!(disc > 0.0f)) return kBig;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float tin = -bs - sq, tout = -bs + sq;
    return tin >= 0.0f ? tin : (tout > 0.0f ? 0.0f : kBig);
  }
  box_span(px, py, pz, vx, vy, vz, hx + rad, hy + rad, hz + rad, tn, tf);
  return (tn <= tf && tf > 0.0f) ? fmaxf(tn, 0.0f) : kBig;
}

__device__ __forceinline__ float cap_sphere_hit(float ex, float ey, float ez, float rad,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz) {
  const float ocx = ox - ex, ocy = oy - ey, ocz = oz - ez;
  const float bb = ocx * dx + ocy * dy + ocz * dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float dd = bb * bb - cc;
  const float ti = -bb - sqrtf(fmaxf(dd, 0.0f));
  return (dd > 0.0f && ti >= 0.0f) ? ti : kBig;
}

// 1 / (ba·ba + 1e-9) of a capsule's axis ba: a row constant, which the march
// stages once (trace_march.cu) and the analytic refine forms per evaluation.
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

// Distance from p to the capsule's axis segment.
__device__ __forceinline__ float capsule_axis_distance(const float* c, float px, float py,
                                                       float pz) {
  const float bax = c[3] - c[0], bay = c[4] - c[1], baz = c[5] - c[2];
  return axis_distance(c[0], c[1], c[2], bax, bay, baz, capsule_inv_denom(bax, bay, baz),
                       px, py, pz);
}

// True where the capsule, grown by 5 cm, holds the point.
__device__ __forceinline__ bool capsule_holds(const float* c, float px, float py, float pz) {
  return capsule_axis_distance(c, px, py, pz) <= c[6] + 0.05f;
}

__device__ __forceinline__ float capsule_hit(const float* c, float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
  // origin inside: static rows hit at 0, dynamic rows (active == 2) are the
  // agent's own body and stay invisible
  if (capsule_holds(c, ox, oy, oz)) return c[7] > 1.5f ? kBig : 0.0f;

  const float ax = c[0], ay = c[1], az = c[2];
  const float bx = c[3], by = c[4], bz = c[5];
  const float rad = c[6];
  const float bax = bx - ax, bay = by - ay, baz = bz - az;
  const float oax = ox - ax, oay = oy - ay, oaz = oz - az;
  const float baba = bax * bax + bay * bay + baz * baz;
  const float bard = bax * dx + bay * dy + baz * dz;
  const float baoa = bax * oax + bay * oay + baz * oaz;
  const float rdoa = dx * oax + dy * oay + dz * oaz;
  const float oaoa = oax * oax + oay * oay + oaz * oaz;
  const float A = baba - bard * bard;
  const float Bq = baba * rdoa - baoa * bard;
  const float Cq = baba * oaoa - baoa * baoa - rad * rad * baba;
  const float hq = Bq * Bq - A * Cq;
  const float tcyl = (-Bq - sqrtf(fmaxf(hq, 0.0f))) / fmaxf(A, 1e-9f);
  const float yc = baoa + tcyl * bard;
  const bool ok = hq > 0.0f && A > 1e-7f && yc >= 0.0f && yc <= baba && tcyl >= 0.0f;
  float tk = ok ? tcyl : kBig;
  tk = fminf(tk, cap_sphere_hit(ax, ay, az, rad, ox, oy, oz, dx, dy, dz));
  tk = fminf(tk, cap_sphere_hit(bx, by, bz, rad, ox, oy, oz, dx, dy, dz));
  return tk;
}

// ---------------------------------------------------------------------------
// signed distance of one row, and of the scene
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

__device__ __forceinline__ float box_sdf(const float* b, float px, float py, float pz) {
  return box_sdf_of(b[0], b[1], b[2], b[3], b[4], b[5], b[6], b[7], b[8], b[9], px, py, pz);
}

// Scene SDF at p for the ray whose origin is o. Inactive rows are skipped
// (their distance is kBig). A dynamic capsule that holds the origin is
// skipped too: the test is recomputed per evaluation rather than kept as
// one flag per row, because the row count is a run-time value (a swarm
// scene has hundreds of dynamic rows) and a per-thread bitmask of that
// length would live in local memory and cost every row of every step a
// load; the recomputation costs only the dynamic rows, static scenes pay
// nothing, and the branch is uniform across the block.
__device__ __forceinline__ float scene_sdf(const float* sb, int KB, const float* sc, int KC,
                                           float px, float py, float pz,
                                           float ox, float oy, float oz) {
  float dist = kBig;
  for (int k = 0; k < KB; ++k) {
    const float* b = sb + k * kBoxCols;
    if (b[11] > 0.5f) dist = fminf(dist, box_sdf(b, px, py, pz));
  }
  for (int k = 0; k < KC; ++k) {
    const float* c = sc + k * kCapCols;
    if (!(c[7] > 0.5f)) continue;
    if (c[7] > 1.5f && capsule_holds(c, ox, oy, oz)) continue;
    dist = fminf(dist, capsule_axis_distance(c, px, py, pz) - c[6]);
  }
  return dist;
}

// Sphere-trace march of n_steps from t: t += d while d >= eps and
// t < max_depth. A ray that is done leaves the loop, since its t no longer
// changes. (The analytic kernel's residual refine; trace_march.cu marches
// its own staged rows.)
__device__ __forceinline__ float march(const float* sb, int KB, const float* sc, int KC,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz, float t, int n_steps,
                                       float max_depth, float eps) {
  for (int i = 0; i < n_steps; ++i) {
    const float r = scene_sdf(sb, KB, sc, KC, ox + dx * t, oy + dy * t, oz + dz * t,
                              ox, oy, oz);
    if (r < eps || t >= max_depth) break;
    t = t + r;
  }
  return t;
}

// t + sdf(t), clamped: the residual evaluation that ends every march.
__device__ __forceinline__ float final_eval(const float* sb, int KB, const float* sc, int KC,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz, float t,
                                            float max_depth) {
  const float r = scene_sdf(sb, KB, sc, KC, ox + dx * t, oy + dy * t, oz + dz * t,
                            ox, oy, oz);
  return fminf(fmaxf(t + r, 0.0f), max_depth);
}

}  // namespace vf
