// The ray-triangle test shared by the two triangle kernels: tri_trace.cu (the
// cluster walk: soup, per-camera, variant, worklist and diagnostic tiers) and
// tri_tile.cu (B4, the tile tiers). A triangle is staged once into twelve
// floats of shared memory (stage_triangle) and tested against each ray by one
// of two bodies (test_slot), so both kernels do a test's arithmetic alike, to
// the bit.
//
// Built with --fmad=false and without --use_fast_math, so nothing is fused
// behind the source's back. The per-test dot and cross products are fused
// explicitly with __fmaf_rn: measured on the H100 this takes 15% off the
// per-camera tier and 5% off the soup tier, and moves t by at most 1.6e-4 m
// against the unfused plain PyTorch version, nearer a float64 brute force
// than the unfused form (chip_profile.py split). The staging keeps its
// unfused products, so shared edges stay exact negations and the
// signed-volume body stays watertight.
//
// The Moller-Trumbore body defers its division: u = dot(tv, p) / det and
// v = dot(d, q) / det fail their sign tests when a numerator's sign differs
// from det's and its magnitude exceeds |det| * 2^-125 (then the quotient is a
// negative normal number, never -0), which most tests meet; only the rest
// divide, and they form u, v and t exactly as before, so the result is the
// former formula's to the bit.
#pragma once

namespace {

constexpr int kTile = 1024;     // rays a tile: the cull unit of the prepasses
constexpr int kMaxChunk = 128;  // triangles a stage
constexpr float kBig = 1e9f;

enum Form { kMT = 0, kSV = 1 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// The per-test products, fused: a*b - c*d and a three-term dot product.
__device__ __forceinline__ float diff2(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, ax * bx));
}

// The twelve floats a staged triangle occupies: for kMT [a | b-a | c-a | -],
// for kSV [g0 | g1 | g2 | kt | -].
template <int FORM>
__device__ __forceinline__ void stage_triangle(float4* out, const float* __restrict__ row,
                                               V3 o) {
  if (row == nullptr) {  // a list slot with no triangle: never hits
    out[0] = out[1] = out[2] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const V3 a = {row[0], row[1], row[2]};
  const V3 b = {row[3], row[4], row[5]};
  const V3 c = {row[6], row[7], row[8]};
  V3 p, q, r;
  float k = 0.f;
  if (FORM == kMT) {
    p = a;
    q = sub(b, a);
    r = sub(c, a);
  } else {
    const V3 a_ = sub(a, o), b_ = sub(b, o), c_ = sub(c, o);
    p = cross(b_, c_);
    q = cross(c_, a_);
    r = cross(a_, b_);
    k = dot(a_, p);
  }
  out[0] = make_float4(p.x, p.y, p.z, q.x);
  out[1] = make_float4(q.y, q.z, r.x, r.y);
  out[2] = make_float4(r.z, k, 0.f, 0.f);
}

// One ray against one staged triangle (r0, r1, r2): where the test accepts a
// t below the ray's running best `tbest`, it becomes the best and `pos` (the
// slot's list position) its position. The origin (ox, oy, oz) is read by kMT
// only; kSV's coefficients already hold it.
template <int FORM>
__device__ __forceinline__ void test_slot(float4 r0, float4 r1, float4 r2, float dx, float dy,
                                          float dz, float ox, float oy, float oz, int pos,
                                          float& tbest, int& pbest) {
  if (FORM == kMT) {
    // a = r0.xyz, e1 = (r0.w, r1.x, r1.y), e2 = (r1.z, r1.w, r2.x)
    const float px = diff2(dy, r2.x, dz, r1.w);
    const float py = diff2(dz, r1.z, dx, r2.x);
    const float pz = diff2(dx, r1.w, dy, r1.z);
    const float det = dot3(r0.w, r1.x, r1.y, px, py, pz);
    if (fabsf(det) > 1e-9f) {
      const float tx = ox - r0.x, ty = oy - r0.y, tz = oz - r0.z;
      const float un = dot3(tx, ty, tz, px, py, pz);
      const float qx = diff2(ty, r1.y, tz, r1.x);
      const float qy = diff2(tz, r0.w, tx, r1.y);
      const float qz = diff2(tx, r1.x, ty, r0.w);
      const float vn = dot3(dx, dy, dz, qx, qy, qz);
      // un * (1/det) < 0 for certain where un * sign(det) * 2^125
      // < -|det|; likewise vn
      const float sg = copysignf(0x1p125f, det), lim = -fabsf(det);
      if (un * sg >= lim && vn * sg >= lim) {
        const float inv = 1.0f / det;
        const float u = un * inv;
        const float v = vn * inv;
        const float tk = dot3(r1.z, r1.w, r2.x, qx, qy, qz) * inv;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tk > 1e-4f && tk < tbest) {
          tbest = tk;
          pbest = pos;
        }
      }
    }
  } else {
    // g0 = r0.xyz, g1 = (r0.w, r1.x, r1.y), g2 = (r1.z, r1.w, r2.x), kt = r2.y
    const float w0 = dot3(dx, dy, dz, r0.x, r0.y, r0.z);
    const float w1 = dot3(dx, dy, dz, r0.w, r1.x, r1.y);
    const float w2 = dot3(dx, dy, dz, r1.z, r1.w, r2.x);
    // the three volumes share a sign; zero volumes and all-zero rows
    // give tk = +-inf or NaN, which fails both comparisons below
    if (w0 * w1 >= 0.0f && w0 * w2 >= 0.0f && w1 * w2 >= 0.0f) {
      const float wsum = w0 + w1 + w2;
      const float tk = r2.y * (1.0f / wsum);
      if (tk > 1e-4f && tk < tbest) {
        tbest = tk;
        pbest = pos;
      }
    }
  }
}

}  // namespace
