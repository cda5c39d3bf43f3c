// Exact ray-triangle first hit over per-tile triangle lists, for Hopper
// (sm_90a).
//
// Replaces three TPU kernels of visfly_tpu/render/tri_trace.py:
//   _tri_kernel          (tri_trace_pallas: per-tile culled lists, both bodies)
//   _tri_kernel_soup     (_tri_trace_pallas_soup: block-id lists into the soup)
//   _tri_kernel_camsoup  (_tri_trace_pallas_camsoup: per-camera signed volumes)
// For every ray they compute the smallest accepted t over the list of the
// ray's 1,024-ray tile, the id of the triangle that gave it (the first strict
// minimum in list order), t clipped to [0, max_depth] and hit = t < max_depth.
//
// One kernel serves all three; what differed on the TPU is data here:
//   * the list. `list` holds entry ids into the triangle soup (S, T, 9); an
//     entry is `bs` consecutive triangles (bs = 1: a triangle id; bs = 64 or
//     128: a Morton-ordered block). The TPU kernels read a compacted copy of
//     the rows, or pages, addressed through scalar prefetch; a block of
//     threads simply gathers its rows from the soup.
//   * the body, a template parameter:
//       kMT  Moller-Trumbore on the raw rows with per-ray origins;
//       kSV  signed volumes against one origin shared by `origin_tiles`
//            consecutive tiles (their ray 0): the tile's own for per-tile
//            lists (origin_tiles = 1), the camera's for the per-camera tier.
//            Coefficients g0 = b'xc', g1 = c'xa', g2 = a'xb', kt = a'.g0 with
//            a' = a - o (tri_trace_pallas :743-754).
//     The TPU's per-camera tier builds the same coefficients in a separate
//     pass over device memory (_sv_pages :917; 236 MB of pages at 256 cameras
//     x 23,040 triangles), expanded as g0 = bxc + ox(b - c) so that bxc is
//     shared between cameras. Here the thread that stages a triangle computes
//     its ten coefficients on the way into shared memory, so no page is ever
//     written and nothing is shared between cameras; the expanded form would
//     only cost more, and it cancels: it forms products of world coordinates
//     before it subtracts, so its error grows with the square of the mesh's
//     distance from the origin (chip_profile.py sv reads it). Both tiers
//     therefore subtract the origin first, in the operation order of the
//     plain PyTorch version (render/tri_kernel.py).
//
// A block of 256 threads serves one tile, four rays a thread (ray k*256 +
// thread of the tile, so loads and stores are coalesced, and one shared-memory
// read of a triangle serves four tests). The list is walked in stages of
// `chunk` triangles (at most 128). Before a stage the block votes
// (__syncthreads_or) whether any ray's current best, clamped to max_depth,
// still lies beyond the stage's lower bound lb: the occlusion early-out, one
// barrier per stage, which is also the barrier that frees the staging buffer.
// Stages at or past `nst` are never visited: the count skip. Neither changes
// a pixel (both are conservative).
//
// Bound: the kernel reads 24 bytes a ray and writes 9, which at 1,048,576
// rays is 35 MB, 10 us at 3.35 TB/s; a test is ~35 (signed volumes) or ~65
// (Moller-Trumbore) float32 instructions and a tile runs list length x 1,024
// of them, so beyond a few triangles a tile the kernel is bound by
// operations.
//
// Built with --fmad=false and without --use_fast_math: each operation rounds
// as in the plain PyTorch version, so the two pick the same triangle on
// near ties.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;    // rays a tile: the cull unit of the prepasses
constexpr int kThreads = 256;
constexpr int kRays = kTile / kThreads;
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

template <int FORM>
__global__ void __launch_bounds__(kThreads)
tri_trace_kernel(const float* __restrict__ tris,     // (S, T, 9)
                 const int* __restrict__ list,       // (S, tiles, n_stage*chunk/bs), -1: none
                 const int* __restrict__ nst,        // (S, tiles) stages to walk
                 const float* __restrict__ lb,       // (S, tiles, n_stage)
                 const float* __restrict__ origins,  // (3, S, R)
                 const float* __restrict__ dirs,     // (3, S, R)
                 float* __restrict__ t_out, bool* __restrict__ hit_out,
                 int* __restrict__ gid_out, int S, int T, int R, int n_stage, int chunk,
                 int bs, int origin_tiles, float max_depth) {
  __shared__ float4 rows[kMaxChunk * 3];
  __shared__ int row_gid[kMaxChunk];

  const int tiles = R / kTile;
  const int ti = blockIdx.x, s = blockIdx.y;
  const size_t plane = (size_t)S * R;
  const size_t ray0 = (size_t)s * R + (size_t)ti * kTile + threadIdx.x;
  const size_t tile_idx = (size_t)s * tiles + ti;
  const int* tile_list = list + tile_idx * ((size_t)n_stage * chunk / bs);
  const float* tile_lb = lb + tile_idx * n_stage;
  const int n_walk = min(nst[tile_idx], n_stage);

  V3 o_shared = {0.f, 0.f, 0.f};
  if (FORM != kMT) {  // ray 0 of the tile, or of the camera the tile belongs to
    const size_t r0 = (size_t)s * R + (size_t)(ti / origin_tiles) * origin_tiles * kTile;
    o_shared = {origins[r0], origins[plane + r0], origins[2 * plane + r0]};
  }

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tbest[kRays];
  int gbest[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t idx = ray0 + (size_t)k * kThreads;
    if (FORM == kMT) {
      ox[k] = origins[idx];
      oy[k] = origins[plane + idx];
      oz[k] = origins[2 * plane + idx];
    }
    dx[k] = dirs[idx];
    dy[k] = dirs[plane + idx];
    dz[k] = dirs[2 * plane + idx];
    tbest[k] = kBig;
    gbest[k] = 0;
  }

  for (int ci = 0; ci < n_walk; ++ci) {
    const float bound = tile_lb[ci];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) open = open || (bound < fminf(tbest[k], max_depth));
    // a barrier as well: every thread is done with the previous stage's rows
    if (!__syncthreads_or(open)) continue;

    if (threadIdx.x < chunk) {
      const int j = threadIdx.x;
      const int entry = tile_list[(ci * chunk + j) / bs];
      const int gid = entry < 0 ? -1 : entry * bs + j % bs;
      const bool real = gid >= 0 && gid < T;
      row_gid[j] = real ? gid : 0;
      stage_triangle<FORM>(rows + 3 * j, real ? tris + ((size_t)s * T + gid) * 9 : nullptr,
                           o_shared);
    }
    __syncthreads();

    for (int j = 0; j < chunk; ++j) {
      const float4 r0 = rows[3 * j], r1 = rows[3 * j + 1], r2 = rows[3 * j + 2];
      const int gid = row_gid[j];
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (FORM == kMT) {
          // a = r0.xyz, e1 = (r0.w, r1.x, r1.y), e2 = (r1.z, r1.w, r2.x)
          const float px = dy[k] * r2.x - dz[k] * r1.w;
          const float py = dz[k] * r1.z - dx[k] * r2.x;
          const float pz = dx[k] * r1.w - dy[k] * r1.z;
          const float det = r0.w * px + r1.x * py + r1.y * pz;
          if (fabsf(det) > 1e-9f) {
            const float inv = 1.0f / det;
            const float tx = ox[k] - r0.x, ty = oy[k] - r0.y, tz = oz[k] - r0.z;
            const float u = (tx * px + ty * py + tz * pz) * inv;
            const float qx = ty * r1.y - tz * r1.x;
            const float qy = tz * r0.w - tx * r1.y;
            const float qz = tx * r1.x - ty * r0.w;
            const float v = (dx[k] * qx + dy[k] * qy + dz[k] * qz) * inv;
            const float tk = (r1.z * qx + r1.w * qy + r2.x * qz) * inv;
            if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tk > 1e-4f && tk < tbest[k]) {
              tbest[k] = tk;
              gbest[k] = gid;
            }
          }
        } else {
          // g0 = r0.xyz, g1 = (r0.w, r1.x, r1.y), g2 = (r1.z, r1.w, r2.x), kt = r2.y
          const float w0 = dx[k] * r0.x + dy[k] * r0.y + dz[k] * r0.z;
          const float w1 = dx[k] * r0.w + dy[k] * r1.x + dz[k] * r1.y;
          const float w2 = dx[k] * r1.z + dy[k] * r1.w + dz[k] * r2.x;
          // the three volumes share a sign; zero volumes and all-zero rows
          // give tk = +-inf or NaN, which fails both comparisons below
          if (w0 * w1 >= 0.0f && w0 * w2 >= 0.0f && w1 * w2 >= 0.0f) {
            const float wsum = w0 + w1 + w2;
            const float tk = r2.y * (1.0f / wsum);
            if (tk > 1e-4f && tk < tbest[k]) {
              tbest[k] = tk;
              gbest[k] = gid;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t idx = ray0 + (size_t)k * kThreads;
    const float t = fminf(fmaxf(tbest[k], 0.0f), max_depth);
    t_out[idx] = t;
    hit_out[idx] = t < max_depth;
    gid_out[idx] = gbest[k];
  }
}

}  // namespace

// form: 0 Moller-Trumbore, 1 signed volumes against the origin of ray 0 of
// every `origin_tiles` tiles. R must be a multiple of 1,024, chunk at most 128
// and a multiple of bs. Returns the CUDA error of the launch (0: none).
extern "C" int tri_trace_launch(const float* tris, const int* list, const int* nst,
                                const float* lb, const float* origins, const float* dirs,
                                float* t_out, bool* hit_out, int* gid_out, int S, int T, int R,
                                int n_stage, int chunk, int bs, int origin_tiles,
                                float max_depth, int form, cudaStream_t stream) {
  if (R % kTile != 0 || chunk < 1 || chunk > kMaxChunk || bs < 1 || chunk % bs != 0 ||
      origin_tiles < 1 || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(R / kTile, S);
#define VF_LAUNCH(FORM)                                                                   \
  tri_trace_kernel<FORM><<<grid, kThreads, 0, stream>>>(                                  \
      tris, list, nst, lb, origins, dirs, t_out, hit_out, gid_out, S, T, R, n_stage,      \
      chunk, bs, origin_tiles, max_depth)
  if (form == kMT) VF_LAUNCH(kMT);
  else VF_LAUNCH(kSV);
#undef VF_LAUNCH
  return (int)cudaGetLastError();
}
