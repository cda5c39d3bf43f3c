// The list walk of the exact ray-triangle first hit, for Hopper (sm_90a):
// B4, the tile tiers, B7a and B7c, the merged and worklist tiers, and the
// two diagnostics B8a (stages executed) and B8b (the knock-outs).
//
// Replaces, in visfly_tpu/render/tri_trace.py,
//   _tri_kernel           (:553, behind tri_trace_pallas :653) on its two tile
//                         tiers: lists of triangle ids culled per triangle
//                         (T <= 2,048) or by 64-triangle clusters (up to
//                         16,384), Moller-Trumbore with per-ray origins (kMT,
//                         tiles that are no camera's rows) or signed volumes
//                         against the tile's one origin, its ray 0 (kSV,
//                         camera tiles);
//   _tri_kernel_camsoup2  (:999, B7a): signed volumes against the camera's
//                         origin over padded lists of 128-triangle Morton
//                         blocks, one block a stage, written as one merged
//                         float32 block (tiles, 2, 1024) of t and the id;
//   _tri_kernel_worklist  (:1454, B7c): signed volumes against the tile's
//                         origin over a CSR list (a scene's stages in one
//                         array, a tile's from `start` on, `nst` of them) of
//                         16-triangle clusters, eight to a stage;
// and in examples/
//   _tri_probe.py::_probe_kernel (:30, B8a): the soup kernel (Moller-Trumbore
//                         over lists of 64- or 128-triangle blocks) counting
//                         the stages a tile executes (COUNT, any list above);
//   _tri_kernel_exp.py::make_kernel (:39, B8b): B7a with its tests (BODY off)
//                         or its gathers (PIN) knocked out.
// For every ray it computes the smallest accepted t over its 1,024-ray
// tile's list, clipped to [0, max_depth], hit = t < max_depth, and the id of
// the triangle that gave it: the first strict minimum in list order, 0 where
// nothing was accepted. The test is tri_body.cuh's arithmetic, shared with
// the cluster walk of tri_trace.cu, which served all three tiers before this
// kernel and still serves the soup (B5) and per-camera (B6) tiers: t and hit
// equal the cluster walk's at k = 1 to the bit, and so does the id of every
// ray that hits.
//
// An entry of a list is `bs` consecutive triangles of the scene's soup (bs =
// 1: a triangle id; 16: a worklist cluster; 128: a Morton block), a stage
// `chunk` triangles of whole entries. What differs between the tiers is data
// or a template flag here: `start` (null: padded lists of n_stage stages a
// tile), the origin shared by `origin_tiles` tiles (1: each tile's own), the
// merged output (MERGED), and the stage shares (SPLIT).
//
// The diagnostics are template flags of the same walk, so that they measure
// the kernel that renders launch; every render instance has them off, which
// compiles them away:
//   COUNT  each block writes the stages its own rays voted to run into its own
//          slot of cnt_out (S * tiles * 2; the wrapper sums a tile's two);
//   BODY   off: a stage is gathered and staged and one staged value read, but
//          nothing is tested, so every ray ends at max_depth;
//   PIN    every stage gathers the rows of the list's first stage (its real
//          slots), and a win's id is that stage's slot at the win's position
//          in its stage. BODY off and PIN together leave the launch, the votes
//          and the barriers: B8b splits B7a's time into those, the staging of
//          the walked stages and the tests.
//
// What bounds it on the H100: operations, and the issue of them. A kSV test
// is three fused dot products and three sign products to its gate: the bound
// (chip_smoke.py::tri_bound_ms) credits 18 float32 operations, nine
// FMA-equivalent issue slots, but the card issues every multiply, compare,
// load and branch as an instruction of its own. The slot loop issues 20.06
// instructions a test (chip_profile.py list reads its SASS: 6 FFMA, 6 FMUL,
// 3 FSETP, a branch and its convergence barrier a test, 3 LDS a slot of two
// tests), so the walk cannot pass
// 9 / 20.06 = 44.9% of the bound; B7a and B7c run at 40.0-40.4% of it,
// about 90% of that issue floor (NVIDIA H100 80GB HBM3, 700.00 W). A tile runs
// (its walked real slots) x 1,024 tests, less what the occlusion early-out
// skips; the bytes (12 a ray in, 8 or 9 out, 36 a staged triangle) take a
// tenth of that time or less.
//
// The design, against what held the cluster walk back, each step's effect on
// path D's B7a and B7c at 23,040 triangles and 1,048,576 rays, on the device
// (chip_profile.py list, which takes each step back in turn, and sweep;
// chip_profile.py tile does the same for B4; PERF.md section 6):
//   1. The card is filled longest walk first. The host hands the tiles in
//      order of their real slots, most first (TileLists.order), and a tile's
//      blocks launch in that order: the longest walks start in the first
//      round of resident blocks and the short ones fill the last. The block
//      scheduler hands out blocks in launch order, so a persistent grid with
//      a counter would do the same with more code. In index order the walk
//      takes 26% (B7a) and 35% (B7c) more time; the cluster walk's k = 2
//      bought part of that tail back with a barrier and an exchange every
//      round and a merge.
//   2. The walk's shape is fixed: a block takes kRays x kThreads = 512 of its
//      tile's rays (ray k * 256 + thread of the block's share, so loads and
//      stores are coalesced and one shared-memory read of a staged triangle
//      serves two tests), two blocks a tile on every tier
//      (render/tri_kernel.py: TILE_BLOCK_RAYS), and walks the tile's list
//      with its own running best, list position and early-out vote: no
//      cluster and no exchange. One block of 256 x 4 a tile (with the body
//      sv_slot below step 4 names) was 0.4-1% slower on B7a and B7c, the
//      cluster walk at k = 2 in the same longest-first order 8-10%; both are
//      copy edits of chip_profile.py list, not shapes of this source. With
//      SPLIT (kSV only), P blocks of the same rays take a tile's stages c,
//      c + P, ... each, and the last of them to finish merges their bests by
//      (t, list position), the sequential walk's first strict minimum: the
//      wrapper asks for it on B7a and B7c where the tiles' blocks fill the
//      card's resident blocks fewer than three times (render/tri_kernel.py::
//      stage_parts). On path D's first 8 cameras (32 tiles) 8 shares take
//      0.1346 ms against 0.6414 with one and the cluster walk's 0.2425 at
//      k = 8; at 92,160 triangles, cap = T, 0.5358 against 2.9422 and 0.8385.
//   3. Only real slots are walked. The host hands each tile's real count,
//      the slots from its first on that hold a triangle the cull kept
//      (TileLists.count), and the last stage's loop stops there. The
//      worklist's slots past a tile's visible clusters hold none (-1); the
//      cluster walk staged them as zero rows and tested all 128 slots of the
//      last stage. At the worklist's default budget most quotas end on whole
//      stages, and the step changes nothing measurable; with a budget for
//      every stage it takes 3% off. B7a's blocks are whole: there the count
//      only drops the one stage of a tile that sees no block (whose bound
//      never lets it run), and changes nothing.
//   4. The slot loop is unrolled 8 times, so that its counter, its branch and
//      the loads' address arithmetic are shared over 16 tests (20.06
//      instructions a test, against 23.50 not unrolled and 20.62 unrolled 4
//      times, which take 8-18% and 1-2% more time). The test itself is
//      test_slot<kSV>'s, branch and all. A body with the sign tests as one
//      predicate chain and the accepted path (the volumes' sum, the IEEE
//      reciprocal, the update) as one branch a slot out of line of the tests
//      (sv_slot, a copy edit of chip_profile.py list) issues fewer
//      instructions at 2 rays a thread (19.06 a test) and takes 8% more time
//      on B7a (B7c: within 1%); it took 7% off the 4-ray shape, which step 2
//      did not keep. It keeps the sign products' own semantics (+-0, an
//      underflowing product, NaN and +-inf gate as before) and every test's
//      arithmetic: t to the bit.
//   5. The gather overlaps the tests. Every thread gathers a share of the
//      next stage's raw rows (cp.async into the second of two buffers) while
//      the current stage is tested; entries of a multiple of 4 triangles in
//      a 16-byte aligned soup go 16 bytes a copy (an entry is one contiguous
//      run of 36 bs bytes; a B7a stage is one run of 4,608): one float a copy
//      takes 2-4% more time. A stage's rows become staged coefficients
//      (stage_triangle) from shared memory after its vote. Waiting for the
//      gather before the tests measured the same (the soup sits in L2).
// The wrapper (render/tri_kernel.py::tri_first_hit) routes the three tiers
// and the two diagnostics here unless a caller asks for a split k of the
// cluster walk; chip_smoke.py phase 3 holds the result to the cluster walk at
// k = 1 and at its picked k (t and hit to the bit, ids wherever a ray hits),
// and the stage count and the knock-outs to their plain versions.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tri_body.cuh"

namespace {

constexpr int kThreads = 256;              // threads a block
constexpr int kRays = 2;                   // rays a thread
constexpr int kBlockRays = kThreads * kRays;  // rays a block
constexpr int kParts = kTile / kBlockRays;    // blocks a tile's rays take
constexpr int kRawFloats = kMaxChunk * 9;  // a stage's raw rows
constexpr int kMaxStageParts = 8;          // stage shares a tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The raw rows of slots [pos0, pos0 + m) of a tile's walk into dst, every
// thread of the block a share: float f of dst is component f % 9 of slot f /
// 9. A slot with no triangle gets a zero row, which never hits in either
// body. The rows have landed after cp.async.wait_group 0 and a barrier.
// `vec`: whole entries 16 bytes a copy (bs a multiple of 4, T of bs, the soup
// 16-byte aligned; pos0 is a multiple of bs); else one float at a time (the
// ids' loads hit L1 after the first: reading a thread's share of ids into
// registers before its copies took 96 (kSV) and 124 (kMT) registers a thread
// at 128 threads, where the walk needs half that).
__device__ __forceinline__ void gather(float* __restrict__ dst, const int* __restrict__ tile_list,
                                       int pos0, int m, int bs, bool vec,
                                       const float* __restrict__ soup, int T) {
  if (vec) {
    const int per = 9 * bs / 4;  // 16-byte copies an entry
    const int e0 = pos0 / bs;
    const int n = (m + bs - 1) / bs * per;
#pragma unroll 1
    for (int v = threadIdx.x; v < n; v += kThreads) {
      const int k = v / per;
      const int entry = tile_list[e0 + k];
      if (entry >= 0 && entry < T / bs)
        cp_async16(dst + 4 * v, soup + (size_t)entry * bs * 9 + 4 * (v - k * per));
      else
        *reinterpret_cast<float4*>(dst + 4 * v) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 1
    for (int f = threadIdx.x; f < 9 * m; f += kThreads) {
      const int j = f / 9, p = pos0 + j;
      const int q = bs == 1 ? p : p / bs;
      const int entry = tile_list[q];
      const int id = bs == 1 ? entry : entry * bs + (p - q * bs);
      if (entry >= 0 && id < T)
        cp_async4(dst + f, soup + (size_t)id * 9 + (f - 9 * j));
      else
        dst[f] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// No bound on the blocks an SM: tri_tile_occupancy reports what ptxas gave.
template <int FORM, bool MERGED, bool SPLIT, bool COUNT = false, bool BODY = true,
          bool PIN = false>
__global__ void __launch_bounds__(kThreads)
tri_tile_kernel(const float* __restrict__ tris,     // (S, T, 9)
                const int* __restrict__ list,       // stages of chunk / bs entry ids, -1: none
                const int* __restrict__ nst,        // (S, tiles) stages a tile owns
                const int* __restrict__ start,      // (S, tiles) first stage (CSR), or null
                const int* __restrict__ cnt,        // (S, tiles) real slots
                const float* __restrict__ lb,       // a stage's lower bound
                const int* __restrict__ order,      // S * tiles tiles in launch order, or null
                const float* __restrict__ origins,  // (3, S, R)
                const float* __restrict__ dirs,     // (3, S, R)
                float* __restrict__ t_out, bool* __restrict__ hit_out,
                int* __restrict__ gid_out,
                float* __restrict__ part_t,          // (S * tiles, P, 1024) or null (P = 1)
                int* __restrict__ part_pos,          // the same
                unsigned* __restrict__ part_done,    // (S * tiles * kParts) zeros, or null
                int* __restrict__ cnt_out,           // COUNT: (S * tiles * kParts) stages run
                int S, int T, int R, int n_stage, int chunk, int bs, int origin_tiles,
                int stage_parts, bool vec, float max_depth) {
  const int P = SPLIT ? stage_parts : 1;  // stage shares a tile: without SPLIT the code has none
  static_assert(kTile % kBlockRays == 0, "a block takes an equal share of a tile's rays");
  static_assert(!(COUNT && SPLIT), "a counting block walks all of its tile's stages");
  __shared__ __align__(16) float raw[2][kRawFloats];  // raw rows of the stage tested and the next
  __shared__ float4 rows[kMaxChunk * 3];              // the stage being tested, staged
  __shared__ bool last;                               // P > 1: the tile's last block to finish

  const int tiles = R / kTile;
  // a tile's kParts x P blocks launch together: ray share `part`, stage share `sp`
  const int item = blockIdx.x / (kParts * P), part = blockIdx.x % kParts;
  const int sp = blockIdx.x / kParts % P;
  const size_t tile_idx = order != nullptr ? (size_t)order[item] : (size_t)item;
  const size_t s = tile_idx / tiles, ti = tile_idx % tiles;
  const size_t plane = (size_t)S * R;
  const size_t ray_base = s * R + ti * kTile;
  const int i0 = part * kBlockRays + threadIdx.x;  // the thread's first ray in the tile
  const size_t stage0 = start != nullptr ? s * n_stage + start[tile_idx] : tile_idx * n_stage;
  const int* tile_list = list + stage0 * (chunk / bs);
  const float* tile_lb = lb + stage0;
  const float* soup = tris + s * T * 9;
  const int n_own = start != nullptr ? nst[tile_idx] : min(nst[tile_idx], n_stage);
  const int n_real = max(0, min(cnt[tile_idx], n_own * chunk));
  const int n_walk = (n_real + chunk - 1) / chunk;
  const int m_pin = min(chunk, n_real);  // PIN: the real slots of the first stage
  int n_ran = 0;                         // COUNT: stages the block's vote ran

  V3 o_shared = {0.f, 0.f, 0.f};
  if (FORM == kSV) {  // ray 0 of the tile, or of the camera the tile belongs to
    const size_t r0 = s * R + (ti / origin_tiles) * origin_tiles * kTile;
    o_shared = {origins[r0], origins[plane + r0], origins[2 * plane + r0]};
  }

  float ox[kRays] = {}, oy[kRays] = {}, oz[kRays] = {}, dx[kRays], dy[kRays], dz[kRays];
  float tbest[kRays];
  int pbest[kRays];  // list position of the best, -1: none
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t idx = ray_base + i0 + (size_t)k * kThreads;
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
  }

  if (sp < n_walk)
    gather(raw[0], tile_list, PIN ? 0 : sp * chunk, PIN ? m_pin : min(chunk, n_real - sp * chunk),
           bs, vec, soup, T);
  for (int ci = sp, it = 0; ci < n_walk; ci += P, ++it) {
    const float bound = tile_lb[ci];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) open = open || bound < fminf(tbest[k], max_depth);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's share of stage ci
    // a barrier as well: every share of stage ci's rows has landed, and every
    // thread is done with the rows last tested and with the buffer that the
    // next gather fills (the previous stage's)
    const bool run = __syncthreads_or(open);
    if (ci + P < n_walk)
      gather(raw[(it + 1) & 1], tile_list, PIN ? 0 : (ci + P) * chunk,
             PIN ? m_pin : min(chunk, n_real - (ci + P) * chunk), bs, vec, soup, T);
    if (!run) continue;
    if (COUNT) ++n_ran;
    const int m = PIN ? m_pin : min(chunk, n_real - ci * chunk);
    for (int j = threadIdx.x; j < m; j += kThreads)
      stage_triangle<FORM>(rows + 3 * j, raw[it & 1] + 9 * j, o_shared);
    __syncthreads();
    if (!BODY) {  // the stage is staged and one value of it is read; no test
#pragma unroll
      for (int k = 0; k < kRays; ++k) tbest[k] = fminf(tbest[k], kBig + fabsf(rows[0].x));
      continue;
    }

    const int pos0 = ci * chunk;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float4 r0 = rows[3 * j], r1 = rows[3 * j + 1], r2 = rows[3 * j + 2];
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        test_slot<FORM>(r0, r1, r2, dx[k], dy[k], dz[k], ox[k], oy[k], oz[k], pos0 + j,
                        tbest[k], pbest[k]);
    }
  }

  if (COUNT && threadIdx.x == 0) cnt_out[tile_idx * kParts + part] = n_ran;
  if (SPLIT) {  // stage shares: the tile's last block merges them by (t, list position)
    const size_t part0 = tile_idx * P * kTile;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      part_t[part0 + (size_t)sp * kTile + i0 + k * kThreads] = tbest[k];
      part_pos[part0 + (size_t)sp * kTile + i0 + k * kThreads] = pbest[k];
    }
    __threadfence();  // the shares are visible before the count says so
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&part_done[tile_idx * kParts + part], 1u) == P - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      float bt = kBig;
      int bp = INT_MAX;
      for (int r = 0; r < P; ++r) {
        const size_t idx = part0 + (size_t)r * kTile + i0 + k * kThreads;
        const float t = __ldcg(part_t + idx);
        const int p = __ldcg(part_pos + idx);
        if (p >= 0 && (t < bt || (t == bt && p < bp))) {
          bt = t;
          bp = p;
        }
      }
      tbest[k] = bt;
      pbest[k] = bp == INT_MAX ? -1 : bp;
    }
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = i0 + k * kThreads;
    const float t = fminf(fmaxf(tbest[k], 0.0f), max_depth);
    const int p = pbest[k];
    const int q = PIN ? p % chunk : p;  // the slot of the list that won
    const int gid = p < 0 ? 0 : bs == 1 ? tile_list[q] : tile_list[q / bs] * bs + q % bs;
    if (MERGED) {
      const size_t idx = tile_idx * (2 * kTile) + i;
      t_out[idx] = t;
      t_out[idx + kTile] = (float)gid;
    } else {
      t_out[ray_base + i] = t;
      hit_out[ray_base + i] = t < max_depth;
      gid_out[ray_base + i] = gid;
    }
  }
}

using TileKernel = void (*)(const float*, const int*, const int*, const int*, const int*,
                            const float*, const int*, const float*, const float*, float*, bool*,
                            int*, float*, int*, unsigned*, int*, int, int, int, int, int, int, int,
                            int, bool, float);

// The instantiation of (form, merged, stage shares > 1, count, knock-out
// bits: 1 the body off, 2 the stage pinned), null if there is none: the
// merged output and the stage shares belong to the signed-volume body, the
// count to the scalar output of either body at one share, the knock-outs to
// the merged output.
TileKernel tile_kernel_of(int form, int merged, bool split, int count, int knock) {
  if (count) {
    if (merged || split || knock) return nullptr;
    if (form == kMT) return tri_tile_kernel<kMT, false, false, true>;
    return form == kSV ? tri_tile_kernel<kSV, false, false, true> : nullptr;
  }
  if (knock) {
    if (form != kSV || !merged) return nullptr;
    switch (knock) {
      case 1: return split ? tri_tile_kernel<kSV, true, true, false, false, false>
                           : tri_tile_kernel<kSV, true, false, false, false, false>;
      case 2: return split ? tri_tile_kernel<kSV, true, true, false, true, true>
                           : tri_tile_kernel<kSV, true, false, false, true, true>;
      case 3: return split ? tri_tile_kernel<kSV, true, true, false, false, true>
                           : tri_tile_kernel<kSV, true, false, false, false, true>;
      default: return nullptr;
    }
  }
  if (form == kMT && !merged && !split) return tri_tile_kernel<kMT, false, false>;
  if (form != kSV) return nullptr;
  if (split) return merged ? tri_tile_kernel<kSV, true, true> : tri_tile_kernel<kSV, false, true>;
  return merged ? tri_tile_kernel<kSV, true, false> : tri_tile_kernel<kSV, false, false>;
}

}  // namespace

// form: 0 Moller-Trumbore, 1 signed volumes against ray 0 of every
// `origin_tiles` tiles. R must be a multiple of 1,024, chunk at most 128 and a
// multiple of bs. `start` null: padded lists of n_stage stages of chunk / bs
// entry ids a tile; else a CSR list of n_stage stages a scene, a tile's nst
// from start on. cnt: each tile's real slots. order null: the tiles in index
// order; else the S * tiles tile indices (s * tiles + tile) in the order their
// blocks launch. merged: t and the id as a float in one (S, tiles, 2, 1024)
// block in t_out (signed volumes only). A block takes 512 of a tile's rays.
// P: stage shares a tile (1 to 8, above 1 signed volumes only): block sp of a
// tile's rays walks its stages sp, sp + P, ... and the tile's last block to
// finish merges the shares by (t, list position), through part_t and part_pos
// (S * tiles * P * 1,024 each) and part_done (S * tiles * 2 counters, zero on
// the call); all three may be null where P is 1. count: each block writes the
// stages it ran to cnt_out[tile * 2 + block] (P 1, the scalar output). knock
// (the merged output): bit 0 no test, bit 1 every stage the first stage's
// rows. Returns the CUDA error of the launch (0: none).
extern "C" int tri_tile_launch(const float* tris, const int* list, const int* nst,
                               const int* start, const int* cnt, const float* lb, const int* order,
                               const float* origins, const float* dirs, float* t_out,
                               bool* hit_out, int* gid_out, float* part_t, int* part_pos,
                               unsigned* part_done, int* cnt_out, int S, int T, int R,
                               int n_stage, int chunk, int bs, int origin_tiles, int P,
                               float max_depth, int form, int merged, int count, int knock,
                               cudaStream_t stream) {
  const TileKernel kernel = tile_kernel_of(form, merged, P > 1, count, knock);
  const long long blocks = (long long)S * (R / kTile) * kParts * P;
  if (kernel == nullptr || S < 0 || R < 0 || R % kTile != 0 || chunk < 1 ||
      chunk > kMaxChunk || bs < 1 || chunk % bs != 0 || origin_tiles < 1 || n_stage < 1 ||
      P < 1 || P > kMaxStageParts || blocks > INT_MAX ||
      (P > 1 && (part_t == nullptr || part_pos == nullptr || part_done == nullptr)) ||
      (count && cnt_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const bool vec = bs % 4 == 0 && T % bs == 0 && (uintptr_t)tris % 16 == 0;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(tris, list, nst, start, cnt, lb, order,
                                                    origins, dirs, t_out, hit_out, gid_out,
                                                    part_t, part_pos, part_done, cnt_out, S, T,
                                                    R, n_stage, chunk, bs, origin_tiles, P, vec,
                                                    max_depth);
  return (int)cudaGetLastError();
}

// What the card holds of the kernel of (form, merged, count, knock) at one
// stage share: registers a thread, threads and rays a block, blocks an SM.
// Returns the CUDA error (0: none).
extern "C" int tri_tile_occupancy(int form, int merged, int count, int knock, int* regs,
                                  int* threads, int* rays, int* blocks_per_sm) {
  const TileKernel kernel = tile_kernel_of(form, merged, false, count, knock);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *threads = kThreads;
  *rays = kBlockRays;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0);
}
