// Analytic first-hit ray trace against packed primitive scenes, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel visfly_tpu/render/pallas_trace.py::
// _trace_kernel_culled with its tile body _trace_tile(analytic=True,
// n_refine=0) and no winning-id output. Per ray it computes the closed-form
// first hit over one scene's rows:
//   boxes    (S, KB, 13) [cx cy cz hx hy hz r cos sin sign family active id]
//     yaw-rotated box: slab test of the radius-inflated box;
//     hollow room (sign < 0): the slab exit from inside, 0 from outside;
//     sphere (hx+hy+hz < 1e-6): the quadratic;
//   capsules (S, KC, 9)  [ax ay az bx by bz r active id]
//     cylinder quadratic plus two end-cap spheres; a capsule whose inside
//     (within r + 0.05) holds the origin hits at t = 0 when static
//     (active == 1) and is ignored when dynamic (active == 2).
// Output t = clamp(min_k t_k, 0, max_depth) and hit = t < max_depth, with
// rays component-major (3, S, R), so each load and store is coalesced.
//
// One thread traces one ray; blockIdx.y is the scene, whose rows the block
// stages in shared memory ((KB*13 + KC*9)*4 bytes, under 1 KB for the
// bench garage) and every thread walks in a runtime loop. The TPU kernel's
// static unroll, one-hot compaction and per-tile cull were Mosaic
// workarounds; the cull never changes t or hit in this mode and is left out.
//
// Bound at the main-path size (S = 1, R = 1,048,576, KB = 8, KC = 12): about
// 1 M rays x 20 rows x ~40 FP32 operations, ~1 GFLOP, against ~29 MB of
// ray loads and t/hit stores. Both come to tens of microseconds on the
// card, so the env step around the kernel is expected to dominate.
//
// Built without --use_fast_math (approximate sqrt and division move t by
// several ulps and flip hits on grazing rays) and with --fmad=false, so each
// operation rounds as in the plain PyTorch version: grazing rays amplify a
// one-ulp difference in a slab division into millimetres of t.

#include <cuda_runtime.h>

namespace {

constexpr int kBoxCols = 13;
constexpr int kCapCols = 9;
constexpr float kBig = 1e9f;

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

__device__ __forceinline__ float capsule_hit(const float* c, float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
  const float ax = c[0], ay = c[1], az = c[2];
  const float bx = c[3], by = c[4], bz = c[5];
  const float rad = c[6];
  const float bax = bx - ax, bay = by - ay, baz = bz - az;
  const float oax = ox - ax, oay = oy - ay, oaz = oz - az;

  // origin inside (within rad + 5 cm): static rows hit at 0, dynamic rows
  // (active == 2) are the agent's own body and stay invisible
  const float inv_denom = 1.0f / (bax * bax + bay * bay + baz * baz + 1e-9f);
  const float h = fminf(fmaxf((oax * bax + oay * bay + oaz * baz) * inv_denom, 0.0f), 1.0f);
  const float ex = oax - bax * h, ey = oay - bay * h, ez = oaz - baz * h;
  const float d0 = sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f);
  if (d0 <= rad + 0.05f) return c[7] > 1.5f ? kBig : 0.0f;

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

__global__ void trace_analytic_kernel(const float* __restrict__ boxes,
                                      const float* __restrict__ caps,
                                      const float* __restrict__ origins,
                                      const float* __restrict__ dirs,
                                      float* __restrict__ t_out,
                                      bool* __restrict__ hit_out,
                                      int S, int R, int KB, int KC, float max_depth) {
  extern __shared__ float rows[];
  float* sb = rows;
  float* sc = rows + KB * kBoxCols;
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < KB * kBoxCols; i += blockDim.x)
    sb[i] = boxes[(size_t)s * KB * kBoxCols + i];
  for (int i = threadIdx.x; i < KC * kCapCols; i += blockDim.x)
    sc[i] = caps[(size_t)s * KC * kCapCols + i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;  // ragged last block
  const size_t plane = (size_t)S * R;
  const size_t idx = (size_t)s * R + r;
  const float ox = origins[idx], oy = origins[plane + idx], oz = origins[2 * plane + idx];
  const float dx = dirs[idx], dy = dirs[plane + idx], dz = dirs[2 * plane + idx];

  float best = kBig;
  for (int k = 0; k < KB; ++k) {
    const float* b = sb + k * kBoxCols;
    if (b[11] > 0.5f) best = fminf(best, box_hit(b, ox, oy, oz, dx, dy, dz));
  }
  for (int k = 0; k < KC; ++k) {
    const float* c = sc + k * kCapCols;
    if (c[7] > 0.5f) best = fminf(best, capsule_hit(c, ox, oy, oz, dx, dy, dz));
  }
  const float t = fminf(fmaxf(fminf(best, max_depth), 0.0f), max_depth);
  t_out[idx] = t;
  hit_out[idx] = t < max_depth;
}

}  // namespace

extern "C" int trace_analytic_launch(const float* boxes, const float* caps,
                                     const float* origins, const float* dirs,
                                     float* t_out, bool* hit_out,
                                     int S, int R, int KB, int KC, float max_depth,
                                     cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid((R + kThreads - 1) / kThreads, S);
  const size_t smem = (size_t)(KB * kBoxCols + KC * kCapCols) * sizeof(float);
  trace_analytic_kernel<<<grid, kThreads, smem, stream>>>(
      boxes, caps, origins, dirs, t_out, hit_out, S, R, KB, KC, max_depth);
  return (int)cudaGetLastError();
}
