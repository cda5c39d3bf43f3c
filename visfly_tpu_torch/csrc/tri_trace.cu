// Exact ray-triangle first hit over per-tile triangle lists, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of visfly_tpu/render/tri_trace.py
//   _tri_kernel            (tri_trace_pallas: per-tile culled lists, both bodies)
//   _tri_kernel_soup       (_tri_trace_pallas_soup: block-id lists into the soup)
//   _tri_kernel_camsoup    (_tri_trace_pallas_camsoup: per-camera signed volumes)
//   _tri_kernel_camsoup2   (..._camsoup_v2: one merged output block)
//   _tri_kernel_camsoup_mx (..._camsoup_mx: the test as a matrix product)
//   _tri_kernel_worklist   (_tri_trace_pallas_worklist: flattened worklist)
// and the two diagnostic copies examples/_tri_probe.py::_probe_kernel (stages
// executed per tile) and examples/_tri_kernel_exp.py::make_kernel (the body or
// the page traffic knocked out).
// For every ray they compute the smallest accepted t over the list of the
// ray's 1,024-ray tile, the id of the triangle that gave it (the first strict
// minimum in list order), t clipped to [0, max_depth] and hit = t < max_depth.
//
// One kernel, tri_trace_kernel, serves all but the matrix form; what differed
// on the TPU is data or a flag here:
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
//   * the list mode. Padded lists give every tile n_stage stages
//     (`start` null). The worklist tier hands one flattened array a scene
//     with, per tile, the offset `start` of its first stage and its quota of
//     stages `nst` (a CSR list): a block walks its own entries, so the TPU's
//     first/last bits, padding entries, sequential-grid carry and gathered
//     pages have no counterpart. Its entries are 16-triangle clusters, eight
//     to a stage, tested against the tile's origin (kSV, origin_tiles = 1).
//   * the output, a template flag: MERGED writes one float32 block
//     (tiles, 2, 1024) a scene holding t and the winning id as a float (exact
//     below 2^24) and no hit flag; the wrapper derives hit = t < max_depth.
//     On the TPU this variant exists to halve a per-grid-step prologue paid
//     per operand; a GPU block has no such prologue.
//   * stages executed: where `cnt_out` is given, thread 0 writes how many
//     stages of the tile passed the count skip and the early-out vote.
//   * two knock-outs for timing, template flags of the merged output: BODY
//     off stages every triangle and touches one staged value but runs no
//     test (every ray ends at max_depth); PIN makes every stage load the
//     list's first stage. Together they split the kernel's time into launch
//     and barrier floor, staging and arithmetic.
//
// tri_trace_mx_kernel is the per-camera test as a matrix product (the "mx"
// variant): a stage's coefficients are staged as a 4 x (4*128) matrix
// G = [g0 | g1 | g2 | kt] (rows x, y, z and the constant), the rays of the
// tile are the 1,024 x 4 matrix D = [dx dy dz 1], and W = D.G gives the three
// volumes and kt of all 1,024 x 128 tests. Each thread holds four rays and
// accumulates a 4 x (4 triangles x 4 blocks) register tile of W over the
// depth of 4, in float32 on the CUDA cores: Hopper's tensor cores have no
// float32 path, and TF32's ten mantissa bits would move hits by centimetres.
// The TPU keeps the running best as two (1024, 128) slabs reduced once a
// tile (1 MB, no block's shared memory); here it is one best a ray, taken in
// (stage, slot) order with a strict less-than, which picks the same winner
// as the scalar body wherever t is unique. The coefficients subtract the
// origin first, as kSV does; kt rides the product against the constant 1.
// The zero rows of G add exact zeros, so W equals the scalar body's volumes.
//
// A tile's stages are walked by a cluster of `split` blocks (k below) of 256
// threads, four rays a thread (ray r*256 + thread of the tile, so loads and
// stores are coalesced, and one shared-memory read of a triangle serves four
// tests). Block c of the cluster takes stages c, c+k, c+2k, ...:
// each still walks front to back with its own running best and list position
// a ray. The list is walked in stages of `chunk` triangles (at most 128).
// Before a stage the block votes (__syncthreads_or) whether any ray's own best,
// clamped to max_depth, still lies beyond the stage's lower bound lb, and the
// bound is not past the cluster's least best of that ray as of the last
// exchange: the occlusion early-out, one barrier per stage, which is also the
// barrier that frees the staging buffer. After every round of k stages the
// blocks exchange their bests through distributed shared memory (one cluster
// barrier); a bound equal to a known t still runs its stage, so a tie is
// decided by list position as in the sequential walk. Stages at or past `nst`
// are never visited: the count skip. Neither changes a pixel (both are
// conservative). At the end the blocks merge their per-ray bests through
// distributed shared memory by the key (t, list position), the smaller
// position winning a tie: that is the first strict minimum of the sequential
// walk, so the merge takes no atomic operation and no second pass. k = 1 is
// the sequential walk with no cluster; the wrapper picks k so that the grid of
// tiles x k blocks fills the card's SMs in whole rounds.
//
// The Moller-Trumbore body defers its division: u = dot(tv, p) / det and
// v = dot(d, q) / det fail their sign tests when a numerator's sign differs
// from det's and its magnitude exceeds |det| * 2^-125 (then the quotient is a
// negative normal number, never -0), which most tests meet; only the rest
// divide, and they form u, v and t exactly as before, so the result is the
// former formula's to the bit.
//
// Bound: the kernel reads 24 bytes a ray and writes 9, which at 1,048,576
// rays is 35 MB, 10 us at 3.35 TB/s; a test is ~35 (signed volumes) or ~40-55
// (Moller-Trumbore) float32 instructions and a tile runs list length x 1,024
// of them, so beyond a few triangles a tile the kernel is bound by
// operations.
//
// Built with --fmad=false and without --use_fast_math, so nothing is fused
// behind the source's back. The per-test dot and cross products are fused
// explicitly with __fmaf_rn: measured on the H100 this takes 15% off the
// per-camera tier and 5% off the soup tier, and moves t by at most 1.6e-4 m
// against the unfused plain PyTorch version, nearer a float64 brute force
// than the unfused form (chip_profile.py split). The staging keeps its
// unfused products, so shared edges stay exact negations and the
// signed-volume body stays watertight.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 1024;    // rays a tile: the cull unit of the prepasses
constexpr int kThreads = 256;  // threads a block, four rays each
constexpr int kRays = kTile / kThreads;
constexpr int kMaxChunk = 128;  // triangles a stage
constexpr int kMaxSplit = 8;    // blocks a cluster (the portable limit)
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

// Where a tile's stages begin, in stages from the start of `list` and `lb`:
// padded lists give every tile n_stage of them; a CSR list (start given) holds
// n_stage stages a scene and the tile's begin at start[tile].
__device__ __forceinline__ size_t first_stage(const int* __restrict__ start, size_t tile_idx,
                                              int s, int n_stage) {
  return start ? (size_t)s * n_stage + start[tile_idx] : tile_idx * n_stage;
}

// One ray's result: t clipped to [0, max_depth], and the id of the triangle at
// list position `pos` of the tile (walk order; -1: nothing accepted, id 0).
template <bool MERGED, bool PIN>
__device__ __forceinline__ void write_ray(int i, float tbest, int pos,
                                          const int* __restrict__ tile_list, int chunk, int bs,
                                          size_t tile_idx, size_t ray_base, float max_depth,
                                          float* __restrict__ t_out, bool* __restrict__ hit_out,
                                          int* __restrict__ gid_out) {
  const float t = fminf(fmaxf(tbest, 0.0f), max_depth);
  int gid = 0;
  if (pos >= 0) {
    const int j = pos % chunk;
    const int stage = PIN ? 0 : pos / chunk;
    gid = tile_list[(stage * chunk + j) / bs] * bs + j % bs;
  }
  if (MERGED) {
    const size_t idx = tile_idx * (2 * kTile) + i;
    t_out[idx] = t;
    t_out[idx + kTile] = (float)gid;
  } else {
    const size_t idx = ray_base + i;
    t_out[idx] = t;
    hit_out[idx] = t < max_depth;
    gid_out[idx] = gid;
  }
}

// No bound on the blocks an SM: ptxas gives the signed-volume body 48
// registers (5 blocks an SM) and the Moller-Trumbore body 74 (3 blocks); on
// the H100 a bound of 4 blocks an SM (64 registers each) ran no faster.
template <int FORM, bool MERGED, bool BODY, bool PIN>
__global__ void __launch_bounds__(kThreads)
tri_trace_kernel(const float* __restrict__ tris,     // (S, T, 9)
                 const int* __restrict__ list,       // stages of chunk/bs entry ids, -1: none
                 const int* __restrict__ nst,        // (S, tiles) stages to walk
                 const int* __restrict__ start,      // (S, tiles) first stage, or null
                 const float* __restrict__ lb,       // a lower bound a stage
                 const float* __restrict__ origins,  // (3, S, R)
                 const float* __restrict__ dirs,     // (3, S, R)
                 float* __restrict__ t_out, bool* __restrict__ hit_out,
                 int* __restrict__ gid_out, int* __restrict__ cnt_out, int S, int T, int R,
                 int n_stage, int chunk, int bs, int origin_tiles, int split,
                 float max_depth) {
  __shared__ float4 rows[kMaxChunk * 3];
  // split > 1: the bests a block publishes to its cluster (two buffers, so a
  // round's writes never meet the previous round's remote reads), the
  // cluster's least best a ray as of the last exchange (each entry read and
  // written by its own thread only), the final list positions, stages run
  __shared__ float pub[2][kTile];
  __shared__ float xmin[kTile];
  __shared__ int pub_pos[kTile];
  __shared__ int block_ran;

  const int tiles = R / kTile;
  const int ti = blockIdx.x / split, s = blockIdx.y;
  const int rank = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t plane = (size_t)S * R;
  const size_t ray_base = (size_t)s * R + (size_t)ti * kTile;
  const size_t ray0 = ray_base + threadIdx.x;
  const size_t tile_idx = (size_t)s * tiles + ti;
  const size_t stage0 = first_stage(start, tile_idx, s, n_stage);
  const int* tile_list = list + stage0 * (chunk / bs);
  const float* tile_lb = lb + stage0;
  const int n_walk = start ? nst[tile_idx] : min(nst[tile_idx], n_stage);
  int n_ran = 0;

  V3 o_shared = {0.f, 0.f, 0.f};
  if (FORM != kMT) {  // ray 0 of the tile, or of the camera the tile belongs to
    const size_t r0 = (size_t)s * R + (size_t)(ti / origin_tiles) * origin_tiles * kTile;
    o_shared = {origins[r0], origins[plane + r0], origins[2 * plane + r0]};
  }

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tbest[kRays];
  int pbest[kRays];  // list position of the best, -1: none
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
    pbest[k] = -1;
    if (split > 1) xmin[k * kThreads + threadIdx.x] = kBig;
  }

  const int n_round = (n_walk + split - 1) / split;
  for (int m = 0; m < n_round; ++m) {
    const int ci = m * split + rank;
    bool open = false;
    if (ci < n_walk) {
      const float bound = tile_lb[ci];
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        open = open || (bound < fminf(tbest[k], max_depth) &&
                        (split == 1 || bound <= xmin[k * kThreads + threadIdx.x]));
    }
    // a barrier as well: every thread is done with the previous stage's rows
    if (__syncthreads_or(open)) {
      ++n_ran;
      if (threadIdx.x < chunk) {
        const int j = threadIdx.x;
        const int entry = tile_list[((PIN ? 0 : ci) * chunk + j) / bs];
        const int gid = entry < 0 ? -1 : entry * bs + j % bs;
        stage_triangle<FORM>(rows + 3 * j,
                             gid >= 0 && gid < T ? tris + ((size_t)s * T + gid) * 9 : nullptr,
                             o_shared);
      }
      __syncthreads();

      if (!BODY) {  // the stage is loaded and one value of it is read; no test
#pragma unroll
        for (int k = 0; k < kRays; ++k) tbest[k] = fminf(tbest[k], kBig + fabsf(rows[0].x));
      } else {
        const int pos0 = ci * chunk;
        for (int j = 0; j < chunk; ++j) {
          const float4 r0 = rows[3 * j], r1 = rows[3 * j + 1], r2 = rows[3 * j + 2];
#pragma unroll
          for (int k = 0; k < kRays; ++k) {
            if (FORM == kMT) {
              // a = r0.xyz, e1 = (r0.w, r1.x, r1.y), e2 = (r1.z, r1.w, r2.x)
              const float px = diff2(dy[k], r2.x, dz[k], r1.w);
              const float py = diff2(dz[k], r1.z, dx[k], r2.x);
              const float pz = diff2(dx[k], r1.w, dy[k], r1.z);
              const float det = dot3(r0.w, r1.x, r1.y, px, py, pz);
              if (fabsf(det) > 1e-9f) {
                const float tx = ox[k] - r0.x, ty = oy[k] - r0.y, tz = oz[k] - r0.z;
                const float un = dot3(tx, ty, tz, px, py, pz);
                const float qx = diff2(ty, r1.y, tz, r1.x);
                const float qy = diff2(tz, r0.w, tx, r1.y);
                const float qz = diff2(tx, r1.x, ty, r0.w);
                const float vn = dot3(dx[k], dy[k], dz[k], qx, qy, qz);
                // un * (1/det) < 0 for certain where un * sign(det) * 2^125
                // < -|det|; likewise vn
                const float sg = copysignf(0x1p125f, det), lim = -fabsf(det);
                if (un * sg >= lim && vn * sg >= lim) {
                  const float inv = 1.0f / det;
                  const float u = un * inv;
                  const float v = vn * inv;
                  const float tk = dot3(r1.z, r1.w, r2.x, qx, qy, qz) * inv;
                  if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tk > 1e-4f && tk < tbest[k]) {
                    tbest[k] = tk;
                    pbest[k] = pos0 + j;
                  }
                }
              }
            } else {
              // g0 = r0.xyz, g1 = (r0.w, r1.x, r1.y), g2 = (r1.z, r1.w, r2.x), kt = r2.y
              const float w0 = dot3(dx[k], dy[k], dz[k], r0.x, r0.y, r0.z);
              const float w1 = dot3(dx[k], dy[k], dz[k], r0.w, r1.x, r1.y);
              const float w2 = dot3(dx[k], dy[k], dz[k], r1.z, r1.w, r2.x);
              // the three volumes share a sign; zero volumes and all-zero rows
              // give tk = +-inf or NaN, which fails both comparisons below
              if (w0 * w1 >= 0.0f && w0 * w2 >= 0.0f && w1 * w2 >= 0.0f) {
                const float wsum = w0 + w1 + w2;
                const float tk = r2.y * (1.0f / wsum);
                if (tk > 1e-4f && tk < tbest[k]) {
                  tbest[k] = tk;
                  pbest[k] = pos0 + j;
                }
              }
            }
          }
        }
      }
    }
    if (split > 1) {  // exchange: the cluster's least best of every ray
      cg::cluster_group cluster = cg::this_cluster();
      float* mine = pub[m & 1];
#pragma unroll
      for (int k = 0; k < kRays; ++k) mine[k * kThreads + threadIdx.x] = tbest[k];
      cluster.sync();
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        const int i = k * kThreads + threadIdx.x;
        float x = kBig;
        for (int r = 0; r < split; ++r) x = fminf(x, cluster.map_shared_rank(mine, r)[i]);
        xmin[i] = x;
      }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      write_ray<MERGED, PIN>(k * kThreads + threadIdx.x, tbest[k], pbest[k], tile_list, chunk,
                             bs, tile_idx, ray_base, max_depth, t_out, hit_out, gid_out);
    if (cnt_out != nullptr && threadIdx.x == 0) cnt_out[tile_idx] = n_ran;
    return;
  }
  // merge: block c writes the rays c*kThreads.. of every split*kThreads
  cg::cluster_group cluster = cg::this_cluster();
  float* fin = pub[n_round & 1];  // no peer reads it any more
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    fin[k * kThreads + threadIdx.x] = tbest[k];
    pub_pos[k * kThreads + threadIdx.x] = pbest[k];
  }
  if (threadIdx.x == 0) block_ran = n_ran;
  cluster.sync();
  for (int i = rank * kThreads + threadIdx.x; i < kTile; i += split * kThreads) {
    float bt = kBig;
    int bp = INT_MAX;
    for (int r = 0; r < split; ++r) {
      const int p = cluster.map_shared_rank(pub_pos, r)[i];
      const float t = cluster.map_shared_rank(fin, r)[i];
      if (p >= 0 && (t < bt || (t == bt && p < bp))) {
        bt = t;
        bp = p;
      }
    }
    write_ray<MERGED, PIN>(i, bt, bp == INT_MAX ? -1 : bp, tile_list, chunk, bs, tile_idx,
                           ray_base, max_depth, t_out, hit_out, gid_out);
  }
  if (cnt_out != nullptr && rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < split; ++r) total += *cluster.map_shared_rank(&block_ran, r);
    cnt_out[tile_idx] = total;
  }
  cluster.sync();  // no block leaves while a peer still reads its shared memory
}

constexpr int kCol = 4 * kMaxChunk;  // columns of a staged G: [g0 | g1 | g2 | kt]

__global__ void __launch_bounds__(kThreads)
tri_trace_mx_kernel(const float* __restrict__ tris,     // (S, T, 9)
                    const int* __restrict__ list,       // (S, tiles, n_stage) block ids
                    const int* __restrict__ nst,        // (S, tiles)
                    const float* __restrict__ lb,       // (S, tiles, n_stage)
                    const float* __restrict__ origins,  // (3, S, R)
                    const float* __restrict__ dirs,     // (3, S, R)
                    float* __restrict__ t_out, bool* __restrict__ hit_out,
                    int* __restrict__ gid_out, int* __restrict__ cnt_out, int S, int T, int R,
                    int n_stage, int chunk, int origin_tiles, float max_depth) {
  // G, row-major 4 x kCol: rows x, y, z of the three g (column blocks 0-2)
  // and the constant row that carries kt (block 3)
  __shared__ __align__(16) float G[4 * kCol];

  const int tiles = R / kTile;
  const int ti = blockIdx.x, s = blockIdx.y;
  const size_t plane = (size_t)S * R;
  const size_t ray0 = (size_t)s * R + (size_t)ti * kTile + threadIdx.x;
  const size_t tile_idx = (size_t)s * tiles + ti;
  const int* tile_list = list + tile_idx * n_stage;
  const float* tile_lb = lb + tile_idx * n_stage;
  const int n_walk = min(nst[tile_idx], n_stage);
  int n_ran = 0;

  const size_t r0 = (size_t)s * R + (size_t)(ti / origin_tiles) * origin_tiles * kTile;
  const V3 o_cam = {origins[r0], origins[plane + r0], origins[2 * plane + r0]};

  float D[kRays][4];  // the thread's rows of D = [dx dy dz 1]
  float tbest[kRays];
  int gbest[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t idx = ray0 + (size_t)k * kThreads;
    D[k][0] = dirs[idx];
    D[k][1] = dirs[plane + idx];
    D[k][2] = dirs[2 * plane + idx];
    D[k][3] = 1.0f;
    tbest[k] = kBig;
    gbest[k] = 0;
  }

  for (int ci = 0; ci < n_walk; ++ci) {
    const float bound = tile_lb[ci];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) open = open || (bound < fminf(tbest[k], max_depth));
    if (!__syncthreads_or(open)) continue;
    ++n_ran;

    const int entry = tile_list[ci];
    if (threadIdx.x < chunk) {
      const int j = threadIdx.x;
      const int gid = entry < 0 ? -1 : entry * chunk + j;
      float4 c[3];
      stage_triangle<kSV>(c, gid >= 0 && gid < T ? tris + ((size_t)s * T + gid) * 9 : nullptr,
                          o_cam);
      const float g[3][3] = {{c[0].x, c[0].y, c[0].z}, {c[0].w, c[1].x, c[1].y},
                             {c[1].z, c[1].w, c[2].x}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r) G[r * kCol + i * kMaxChunk + j] = g[i][r];
        G[3 * kCol + i * kMaxChunk + j] = 0.0f;
        G[i * kCol + 3 * kMaxChunk + j] = 0.0f;
      }
      G[3 * kCol + 3 * kMaxChunk + j] = c[2].y;
    }
    __syncthreads();

    for (int j0 = 0; j0 < chunk; j0 += 4) {
      float g[4][4][4];  // [row of G][column block][triangle of the four]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(&G[r * kCol + i * kMaxChunk + j0]);
          g[r][i][0] = v.x;
          g[r][i][1] = v.y;
          g[r][i][2] = v.z;
          g[r][i][3] = v.w;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          float w[4];  // the ray's row of W at this triangle: w0, w1, w2, kt
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float acc = D[k][0] * g[0][i][jj];
#pragma unroll
            for (int r = 1; r < 4; ++r) acc = acc + D[k][r] * g[r][i][jj];
            w[i] = acc;
          }
          if (w[0] * w[1] >= 0.0f && w[0] * w[2] >= 0.0f && w[1] * w[2] >= 0.0f) {
            const float wsum = w[0] + w[1] + w[2];
            const float tk = w[3] * (1.0f / wsum);
            if (tk > 1e-4f && tk < tbest[k]) {
              tbest[k] = tk;
              gbest[k] = entry * chunk + j0 + jj;
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
  if (cnt_out != nullptr && threadIdx.x == 0) cnt_out[tile_idx] = n_ran;
}

}  // namespace

using TriKernel = void (*)(const float*, const int*, const int*, const int*, const float*,
                           const float*, const float*, float*, bool*, int*, int*, int, int, int,
                           int, int, int, int, int, float);

// The instantiation of a (form, out, knock) triple, null if there is none.
static TriKernel kernel_of(int form, int out, int knock) {
  if (form < 0 || form > 1 || out < 0 || out > 1 || knock < 0 || knock > 3 ||
      (out == 1 && form != kSV) || (knock != 0 && out != 1))
    return nullptr;
  if (out == 0 && form == kMT) return tri_trace_kernel<kMT, false, true, false>;
  if (out == 0) return tri_trace_kernel<kSV, false, true, false>;
  switch (knock) {
    case 0: return tri_trace_kernel<kSV, true, true, false>;
    case 1: return tri_trace_kernel<kSV, true, false, false>;
    case 2: return tri_trace_kernel<kSV, true, true, true>;
    default: return tri_trace_kernel<kSV, true, false, true>;
  }
}

static cudaLaunchConfig_t launch_config(dim3 grid, int split, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cfg;
}

// form: 0 Moller-Trumbore, 1 signed volumes against the origin of ray 0 of
// every `origin_tiles` tiles. R must be a multiple of 1,024, chunk at most 128
// and a multiple of bs. `start` null: padded lists of n_stage stages a tile;
// else a CSR list of n_stage stages a scene. out: 0 t, hit and id; 1 the merged
// block in t_out (signed volumes only). knock: bit 0 no body, bit 1 the stage
// pinned (merged output only). split: blocks a tile, 1 to 8, launched as one
// thread-block cluster. cnt_out may be null. Returns the CUDA error of the
// launch (0: none).
extern "C" int tri_trace_launch(const float* tris, const int* list, const int* nst,
                                const int* start, const float* lb, const float* origins,
                                const float* dirs, float* t_out, bool* hit_out, int* gid_out,
                                int* cnt_out, int S, int T, int R, int n_stage, int chunk,
                                int bs, int origin_tiles, float max_depth, int form, int out,
                                int knock, int split, cudaStream_t stream) {
  const TriKernel kernel = kernel_of(form, out, knock);
  if (kernel == nullptr || R % kTile != 0 || chunk < 1 || chunk > kMaxChunk || bs < 1 ||
      chunk % bs != 0 || origin_tiles < 1 || split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(dim3(R / kTile * split, S), split, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tris, list, nst, start, lb, origins,
                                             dirs, t_out, hit_out, gid_out, cnt_out, S, T, R,
                                             n_stage, chunk, bs, origin_tiles, split, max_depth);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// What the card holds of one instantiation: registers a thread, threads a
// block, blocks an SM, and with split > 1 the clusters of `split` blocks that
// can be resident at once (else 0). Returns the CUDA error (0: none).
extern "C" int tri_trace_occupancy(int form, int out, int knock, int split, int* regs,
                                   int* threads, int* blocks_per_sm, int* clusters) {
  const TriKernel kernel = kernel_of(form, out, knock);
  if (kernel == nullptr || split < 1 || split > kMaxSplit) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *threads = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *clusters = 0;
  if (split == 1) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(dim3(split), split, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The per-camera test as a matrix product over padded lists of whole blocks
// (bs == chunk, a multiple of 4 up to 128).
extern "C" int tri_trace_mx_launch(const float* tris, const int* list, const int* nst,
                                   const float* lb, const float* origins, const float* dirs,
                                   float* t_out, bool* hit_out, int* gid_out, int* cnt_out,
                                   int S, int T, int R, int n_stage, int chunk,
                                   int origin_tiles, float max_depth, cudaStream_t stream) {
  if (R % kTile != 0 || chunk < 4 || chunk > kMaxChunk || chunk % 4 != 0 || origin_tiles < 1)
    return (int)cudaErrorInvalidValue;
  tri_trace_mx_kernel<<<dim3(R / kTile, S), kThreads, 0, stream>>>(
      tris, list, nst, lb, origins, dirs, t_out, hit_out, gid_out, cnt_out, S, T, R, n_stage,
      chunk, origin_tiles, max_depth);
  return (int)cudaGetLastError();
}
