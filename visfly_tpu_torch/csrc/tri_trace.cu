// Exact ray-triangle first hit over per-tile triangle lists, for Hopper
// (sm_90a): the cluster walk.
//
// Replaces the TPU kernels of visfly_tpu/render/tri_trace.py
//   _tri_kernel_soup       (_tri_trace_pallas_soup: block-id lists into the soup)
//   _tri_kernel_camsoup    (_tri_trace_pallas_camsoup: per-camera signed volumes)
//   _tri_kernel_camsoup2   (..._camsoup_v2: one merged output block)
//   _tri_kernel_camsoup_mx (..._camsoup_mx: the test as a matrix product)
//   _tri_kernel_worklist   (_tri_trace_pallas_worklist: flattened worklist)
// and the two diagnostic copies examples/_tri_probe.py::_probe_kernel (stages
// executed per tile) and examples/_tri_kernel_exp.py::make_kernel (the body or
// the page traffic knocked out). The tile tiers of _tri_kernel (B4: lists of
// triangle ids, per triangle or culled by 64-triangle clusters), the merged
// per-camera tier (B7a), the worklist (B7c) and the two diagnostics (B8a,
// B8b) have a kernel of their own, csrc/tri_tile.cu (the list walk); this one
// walks their lists only where a caller asks for a split k (their former
// design, kept to be timed beside it).
//
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
// variant), on the tensor cores. The TPU kernel forms W = D.G a stage on the
// MXU, D the tile's 1,024 ray directions and G the stage's coefficients
// [g0 | g1 | g2 | kt], with Precision.HIGHEST: a multi-pass split that keeps
// float32's accuracy (one TF32 pass moves hits by metres). Here the product
// is wgmma (m64n96k8, TF32 in, float32 accumulated), split three ways:
// x = hi + lo with hi = rna(x), lo = rna(x - hi) (cvt.rna.tf32, both TF32;
// |x - hi - lo| <= 2^-22 |x|), and
//   d.g ~ [d_hi | d_lo].[g_lo ; 0] + [d_hi | d_lo].[g_hi ; g_hi]
// (two products of depth 8 into one accumulator), which drops only
// d_lo.g_lo. The split works on the magnitude, so it is odd in x to the bit
// and a shared edge's negated coefficients stay exact negations, which the
// H100's tensor cores sum as exact negations too: rays through the midpoints
// of the garage's flat shared edges land where the plain version's do, and an
// earlier mma.sync form that staged every coefficient vector times a
// canonical sign (g and -g as one vector) changed no bit of path D's result.
//
// A block is one tile of 1,024 rays and two warpgroups. A (64 rays x depth 8)
// is the tile's [d_hi | d_lo], split once into shared memory; B (depth 8 x 96)
// is 32 triangles of the stage: the three volumes are three n8 blocks over
// the same eight triangles, so a lane's accumulators hold all three volumes
// of its (ray, triangle) pairs (rays g and g+8 of its warp's 16, triangles
// 2c and 2c+1 of every eight) and the gate runs on the CUDA cores straight
// from them: the least of the three sign products, one test's minimum, and
// the largest of those over the lane's 16 tests, without a predicate a test;
// only the rare tests past it divide. kt is read from shared memory, never
// multiplied: the TPU's constant row only adds exact zeros to it. The
// reciprocal of the volumes' sum is the hardware's approximation with one
// Newton step: IEEE division compiles to a call, and a call anywhere in the
// kernel makes ptxas serialize every wgmma. A ray's running best is spread
// over the four lanes of a quad, each over its own columns in (stage, slot)
// order with a strict less-than; the occlusion vote runs a stage while any
// lane's own best lies beyond its bound (conservative: a lane's best is never
// below its ray's), and at the end the quad merges by (t, list position),
// the smaller position winning a tie: the sequential walk's first strict
// minimum, as the cluster merge below. The coefficients subtract the origin
// first, as kSV does.
//
// What bounds it (chip_profile.py mx reads each part on the card): the
// products take 96 TF32 flops a test on the tensor cores, the gate 6
// instructions a test on the CUDA cores. A warpgroup waits for its product
// before it gates it; the other three warpgroups of the SM keep the tensor
// cores busy meanwhile (two blocks an SM, at most 128 registers). mma.sync,
// tried first, runs at a little over half of wgmma's TF32 rate (the same
// script's probe) and left the kernel slower; so did accumulators
// double-buffered within a warpgroup (one block an SM).
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
// tiles x k blocks fills the card's SMs in whole rounds. Tiles launch in index
// order, or in `order` where one is given (the wrapper gives B7a's and B7c's
// lists theirs, longest walk first, when a split is asked of it; B5, B6 and
// the diagnostics launch in index order).
//
// The test of a ray against a staged triangle, and how it rounds, is
// tri_body.cuh's, shared with tri_tile.cu.
//
// Bound: the kernel reads 24 bytes a ray and writes 9, which at 1,048,576
// rays is 35 MB, 10 us at 3.35 TB/s; a test is ~35 (signed volumes) or ~40-55
// (Moller-Trumbore) float32 instructions and a tile runs list length x 1,024
// of them, so beyond a few triangles a tile the kernel is bound by
// operations.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tri_body.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a block, four rays each
constexpr int kRays = kTile / kThreads;
constexpr int kMaxSplit = 8;  // blocks a cluster (the portable limit)

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
                 const int* __restrict__ order,      // S * tiles tiles in launch order, or null
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
  // the blocks of a grid (tiles x split, S) launch x first: item is the
  // launch position of the block's tile
  const size_t item = (size_t)blockIdx.y * tiles + blockIdx.x / split;
  const size_t tile_idx = order != nullptr ? (size_t)order[item] : item;
  const int ti = (int)(tile_idx % tiles), s = (int)(tile_idx / tiles);
  const int rank = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t plane = (size_t)S * R;
  const size_t ray_base = (size_t)s * R + (size_t)ti * kTile;
  const size_t ray0 = ray_base + threadIdx.x;
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

  float ox[kRays] = {}, oy[kRays] = {}, oz[kRays] = {}, dx[kRays], dy[kRays], dz[kRays];
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
          for (int k = 0; k < kRays; ++k)
            test_slot<FORM>(r0, r1, r2, dx[k], dy[k], dz[k], ox[k], oy[k], oz[k], pos0 + j,
                            tbest[k], pbest[k]);
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

constexpr int kMxThreads = 256;                           // threads a block: 2 warpgroups
constexpr int kMxMinBlocks = 2;                           // blocks an SM: at most 128 registers
constexpr int kMxGroupRays = kTile / (kMxThreads / 128);  // rays a warpgroup
constexpr int kMxRows = kMxGroupRays / 64;                // m64 row blocks a warpgroup
constexpr int kMxCols = 32;  // triangles a product: N = 96 columns, three volumes of 32

// The operands in shared memory, K-major TF32 without swizzle: core matrices
// of 8 rows x 16 bytes (4 of the depth), the next along the depth 128 bytes
// on, the next 8 rows 256 bytes on.
struct MxShared {
  // A of the tile, row block m (rays 64m..64m+63): [d_hi | d_lo] of each ray,
  // component 3 zero
  float4 a[kTile / 64][8][2][8];
  // B of a stage: for each 32-triangle chunk, pass 0 [g_hi ; g_hi] and pass 1
  // [g_lo ; 0], each 12 n8 blocks (n8 block 3u + v: volume v of triangles
  // 8u..8u+7) x 2 depth halves, row i = triangle 8u + i: {x, y, z, 0}; the
  // depth half 1 of pass 1 is zero, written once
  float4 b[kMaxChunk / kMxCols][2][12][2][8];
  float kt[kMaxChunk];
  int pbest[2 * kMxRows][kMxThreads];  // the list position of each lane's best of each ray
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32; lo is rna of |x| - |hi| (exact)
// with x's sign, so the split of -x is that of x negated, to the bit
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  const uint32_t h = tf32_rna(x);
  const float r = fabsf(x) - fabsf(__uint_as_float(h));
  hi = __uint_as_float(h);
  lo = __uint_as_float(
      tf32_rna(__uint_as_float(__float_as_uint(r) ^ (__float_as_uint(x) & 0x80000000u))));
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(128 >> 4) << 16 | (uint64_t)(256 >> 4) << 32;
}

// D (64 x 96) = A.B (ACC false) or D + A.B (ACC true), A 64 x 8 and B 8 x 96
// from shared memory; D per warp of the warpgroup: its 16 rows, d[4j..4j+3]
// the n8 block j (rows g, g, g+8, g+8; cols 8j + 2c, 8j + 2c + 1, ...).
// Asynchronous: the registers of D hold the result after the wait in
// mx_product.
template <bool ACC>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "n"(int(ACC)));
}

// One row block's product with one chunk of triangles: d_hi.g_lo, then
// [d_hi | d_lo].[g_hi ; g_hi] added; waits for it and reads d after the wait.
__device__ __forceinline__ void mx_product(float (&d)[48], uint64_t a, uint64_t b_lo,
                                           uint64_t b_hi) {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  wgmma_n96<false>(d, a, b_lo);
  wgmma_n96<true>(d, a, b_hi);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 1/x to within a unit in the last place: the hardware's approximation and
// one Newton step. IEEE division compiles to a call, and a call anywhere in a
// kernel makes ptxas serialize all its wgmma. 0, +-inf and the subnormals
// give NaN, which fails both of the gate's comparisons, as IEEE division's
// +-inf, NaN or 0 fail them.
__device__ __forceinline__ float rcp_newton(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
}

// The gate of the kSV body on a lane's 16 tests of a row block's product w
// with a chunk: test (u, e) is ray g + 8 (e >> 1) of the warp's 16 and
// triangle 8u + 2c + (e & 1) of the chunk, its volume v in w[12u + 4v + e].
// The least of a test's three products is >= 0 where they all are (its
// volumes share a sign); a NaN product is passed over there, but then a
// volume is infinite or NaN and t is 0 or NaN, which fails t > 1e-4 as it
// fails in the kSV body. So the gate is branch-free and without a predicate
// a test, and only the rare tests past it divide and keep the lane's best of
// each of its two rays (tb, and its list position in pb0, pb1).
__device__ __forceinline__ void mx_gate(const float (&w)[48], const float* __restrict__ kts,
                                        int c, int pos0, float (&tb)[2], int* pb0, int* pb1) {
  float least[16];
  float most = -1.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w0 = w[12 * u + e], w1 = w[12 * u + 4 + e], w2 = w[12 * u + 8 + e];
      least[4 * u + e] = fminf(fminf(w0 * w1, w0 * w2), w1 * w2);
      most = fmaxf(most, least[4 * u + e]);
    }
  }
  if (!(most >= 0.0f)) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 kt = *reinterpret_cast<const float2*>(&kts[8 * u + 2 * c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!(least[4 * u + e] >= 0.0f)) continue;
      const float tk = (e & 1 ? kt.y : kt.x) *
                       rcp_newton(w[12 * u + e] + w[12 * u + 4 + e] + w[12 * u + 8 + e]);
      const int h = e >> 1;
      if (tk > 1e-4f && tk < tb[h]) {
        tb[h] = tk;
        (h ? pb1 : pb0)[0] = pos0 + 8 * u + (e & 1);
      }
    }
  }
}

__global__ void __launch_bounds__(kMxThreads, kMxMinBlocks)
tri_trace_mx_kernel(const float* __restrict__ tris,     // (S, T, 9)
                    const int* __restrict__ list,       // (S, tiles, n_stage) block ids
                    const int* __restrict__ nst,        // (S, tiles)
                    const float* __restrict__ lb,       // (S, tiles, n_stage)
                    const float* __restrict__ origins,  // (3, S, R)
                    const float* __restrict__ dirs,     // (3, S, R)
                    float* __restrict__ t_out, bool* __restrict__ hit_out,
                    int* __restrict__ gid_out, int* __restrict__ cnt_out, int S, int T, int R,
                    int n_stage, int chunk, int origin_tiles, float max_depth) {
  extern __shared__ __align__(128) unsigned char mx_smem[];
  MxShared& sh = *reinterpret_cast<MxShared*>(mx_smem);

  const int tiles = R / kTile;
  const int ti = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, k = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, c = lane & 3;
  const size_t plane = (size_t)S * R;
  const size_t tile_ray0 = (size_t)s * R + (size_t)ti * kTile;
  const size_t tile_idx = (size_t)s * tiles + ti;
  const int* tile_list = list + tile_idx * n_stage;
  const float* tile_lb = lb + tile_idx * n_stage;
  const int n_walk = min(nst[tile_idx], n_stage);
  int n_ran = 0;

  const size_t r0 = (size_t)s * R + (size_t)(ti / origin_tiles) * origin_tiles * kTile;
  const V3 o_cam = {origins[r0], origins[plane + r0], origins[2 * plane + r0]};

  // A of the tile, once: ray i is row i % 64 of row block i / 64
  for (int i = threadIdx.x; i < kTile; i += kMxThreads) {
    float hi[3], lo[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) split_tf32(dirs[r * plane + tile_ray0 + i], hi[r], lo[r]);
    float4* row = &sh.a[i / 64][i % 64 / 8][0][i % 8];
    row[0] = make_float4(hi[0], hi[1], hi[2], 0.f);
    row[8] = make_float4(lo[0], lo[1], lo[2], 0.f);  // the next depth half
  }
  for (int i = threadIdx.x; i < kMaxChunk / kMxCols * 12 * 8; i += kMxThreads)
    sh.b[i / 96][1][i / 8 % 12][1][i % 8] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the lane's rays: g + 8h of its warp's 16 rows of each of its warpgroup's
  // row blocks m, tile rays 64 (kMxRows wg + m) + 16k + g + 8h
  float tb[kMxRows][2];  // the lane's running best of each
#pragma unroll
  for (int m = 0; m < kMxRows; ++m) {
    tb[m][0] = tb[m][1] = kBig;
    sh.pbest[2 * m][threadIdx.x] = sh.pbest[2 * m + 1][threadIdx.x] = -1;
  }

  for (int ci = 0; ci < n_walk; ++ci) {
    // the stage runs while a lane's own best of one of its rays lies beyond
    // the bound: conservative (a ray's best is the least of its quad's), and
    // faster than taking the quad's least first (chip_profile.py mx)
    float far = tb[0][0];
#pragma unroll
    for (int m = 0; m < kMxRows; ++m) far = fmaxf(far, fmaxf(tb[m][0], tb[m][1]));
    // a barrier as well: every thread is done with the previous stage's rows
    if (!__syncthreads_or(tile_lb[ci] < fminf(far, max_depth))) continue;
    ++n_ran;

    const int entry = tile_list[ci];
    if (threadIdx.x < chunk) {
      const int j = threadIdx.x;
      const int gid = entry < 0 ? -1 : entry * chunk + j;
      float4 cf[3];
      stage_triangle<kSV>(cf, gid >= 0 && gid < T ? tris + ((size_t)s * T + gid) * 9 : nullptr,
                          o_cam);
      const float gv[3][3] = {{cf[0].x, cf[0].y, cf[0].z}, {cf[0].w, cf[1].x, cf[1].y},
                              {cf[1].z, cf[1].w, cf[2].x}};
      const int ch = j / kMxCols, u = j % kMxCols / 8, i = j % 8;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        float hi[3], lo[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) split_tf32(gv[v][r], hi[r], lo[r]);
        const float4 big = make_float4(hi[0], hi[1], hi[2], 0.f);
        sh.b[ch][0][3 * u + v][0][i] = big;
        sh.b[ch][0][3 * u + v][1][i] = big;
        sh.b[ch][1][3 * u + v][0][i] = make_float4(lo[0], lo[1], lo[2], 0.f);
      }
      sh.kt[j] = cf[2].y;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the tensor cores
    __syncthreads();

    for (int ch = 0; ch < chunk / kMxCols; ++ch) {
      const uint64_t b_lo = smem_desc(&sh.b[ch][1][0][0][0]);
      const uint64_t b_hi = smem_desc(&sh.b[ch][0][0][0][0]);
      const int pos0 = ci * chunk + ch * kMxCols + 2 * c;
#pragma unroll
      for (int m = 0; m < kMxRows; ++m) {
        float w[48];
        mx_product(w, smem_desc(&sh.a[kMxRows * wg + m][0][0][0]), b_lo, b_hi);
        mx_gate(w, sh.kt + ch * kMxCols, c, pos0, tb[m], &sh.pbest[2 * m][threadIdx.x],
                &sh.pbest[2 * m + 1][threadIdx.x]);
      }
    }
  }

  // merge the quad by (t, list position); lane c < 2 writes its ray g + 8c
#pragma unroll
  for (int m = 0; m < kMxRows; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = tb[m][h];
      int p = sh.pbest[2 * m + h][threadIdx.x];
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const float t2 = __shfl_xor_sync(0xffffffffu, t, x);
        const int p2 = __shfl_xor_sync(0xffffffffu, p, x);
        if (p2 >= 0 && (t2 < t || (t2 == t && p2 < p))) {
          t = t2;
          p = p2;
        }
      }
      if (c == h) {
        const size_t idx = tile_ray0 + 64 * (kMxRows * wg + m) + 16 * k + g + 8 * h;
        const float tc = fminf(fmaxf(t, 0.0f), max_depth);
        t_out[idx] = tc;
        hit_out[idx] = tc < max_depth;
        gid_out[idx] = p < 0 ? 0 : tile_list[p / chunk] * chunk + p % chunk;
      }
    }
  }
  if (cnt_out != nullptr && threadIdx.x == 0) cnt_out[tile_idx] = n_ran;
}

}  // namespace

using TriKernel = void (*)(const float*, const int*, const int*, const int*, const int*,
                           const float*, const float*, const float*, float*, bool*, int*, int*,
                           int, int, int, int, int, int, int, int, float);

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
// else a CSR list of n_stage stages a scene. order null: the tiles in index
// order; else the S * tiles tile indices (s * tiles + tile) in the order their
// blocks launch. out: 0 t, hit and id; 1 the merged
// block in t_out (signed volumes only). knock: bit 0 no body, bit 1 the stage
// pinned (merged output only). split: blocks a tile, 1 to 8, launched as one
// thread-block cluster. cnt_out may be null. Returns the CUDA error of the
// launch (0: none).
extern "C" int tri_trace_launch(const float* tris, const int* list, const int* nst,
                                const int* start, const int* order, const float* lb,
                                const float* origins, const float* dirs, float* t_out,
                                bool* hit_out, int* gid_out, int* cnt_out, int S, int T, int R,
                                int n_stage, int chunk,
                                int bs, int origin_tiles, float max_depth, int form, int out,
                                int knock, int split, cudaStream_t stream) {
  const TriKernel kernel = kernel_of(form, out, knock);
  if (kernel == nullptr || R % kTile != 0 || chunk < 1 || chunk > kMaxChunk || bs < 1 ||
      chunk % bs != 0 || origin_tiles < 1 || split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(dim3(R / kTile * split, S), split, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tris, list, nst, start, order, lb,
                                             origins, dirs, t_out, hit_out, gid_out, cnt_out, S,
                                             T, R, n_stage, chunk, bs, origin_tiles, split,
                                             max_depth);
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

// The per-camera test as a matrix product on the tensor cores, over padded
// lists of whole blocks (bs == chunk, a multiple of 32 up to 128).
extern "C" int tri_trace_mx_launch(const float* tris, const int* list, const int* nst,
                                   const float* lb, const float* origins, const float* dirs,
                                   float* t_out, bool* hit_out, int* gid_out, int* cnt_out,
                                   int S, int T, int R, int n_stage, int chunk,
                                   int origin_tiles, float max_depth, cudaStream_t stream) {
  if (R % kTile != 0 || chunk < kMxCols || chunk > kMaxChunk || chunk % kMxCols != 0 ||
      origin_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tri_trace_mx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(MxShared));
  if (err != cudaSuccess) return (int)err;
  tri_trace_mx_kernel<<<dim3(R / kTile, S), kMxThreads, sizeof(MxShared), stream>>>(
      tris, list, nst, lb, origins, dirs, t_out, hit_out, gid_out, cnt_out, S, T, R, n_stage,
      chunk, origin_tiles, max_depth);
  return (int)cudaGetLastError();
}
