// B4, the tile tiers of the exact ray-triangle first hit, for Hopper (sm_90a).
//
// Replaces visfly_tpu/render/tri_trace.py::_tri_kernel (:553, behind
// tri_trace_pallas :653) on its two tile tiers: lists of triangle ids culled
// per triangle (T <= 2,048) or by 64-triangle clusters (up to 16,384), in
// both of its bodies: Moller-Trumbore with per-ray origins (kMT, tiles that
// are no camera's rows) and signed volumes against the tile's one origin, its
// ray 0 (kSV, camera tiles). For every ray it computes the smallest accepted t
// over its 1,024-ray tile's list, clipped to [0, max_depth], hit = t <
// max_depth, and the id of the triangle that gave it: the first strict
// minimum in list order, 0 where nothing was accepted. The test is
// tri_body.cuh's, shared with the cluster walk of tri_trace.cu, which served
// these tiers before this kernel.
//
// What bounds it on the H100: operations. A test is about 20 float32
// instructions to its gate for kSV (three fused dot products and three sign
// products), 40-55 for kMT, and a tile runs (its real slots) x 1,024 tests,
// less what the early-out skips; the bytes (24 a ray in, 9 out, 36 a staged
// triangle) take a tenth of that time or less (chip_smoke.py phase 3 prints
// both bounds).
//
// The design, against what held the cluster walk back on these short lists
// (chip_profile.py tile times each step of it, taken back one at a time):
//   1. A tile's rays are split, not its stages. A block takes kBlockRays of
//      its tile's 1,024 rays (kThreads threads of kRays rays; ray k*kThreads
//      + thread of the block's share, so loads and stores are coalesced and
//      one shared-memory read of a staged triangle serves kRays tests) and
//      walks the tile's whole list with its own running best and list
//      position a ray. No cluster, no exchange, no merge: a ray's result is
//      the sequential walk's first strict minimum by construction. At 360
//      triangles a tile owns about one stage of 64; the cluster split's
//      second block walked nothing there and still waited at every cluster
//      barrier. Staging the list once more a block costs about 40
//      instructions a triangle against kBlockRays tests of it. The occlusion
//      early-out votes over the block's own rays (one barrier a stage);
//      stages past the tile's n_stage are never visited. Two blocks of 256
//      threads x 2 rays took 7-9% less time than one of 256 x 4 on the
//      360-triangle lists and 4% more on the 5,760-triangle ones, whose
//      longer walks favour four tests a shared-memory read.
//   2. Only real slots are walked. The host hands each tile's real count, the
//      slots from the first on that hold a triangle the cull kept, and the
//      last stage's loop stops there. The cluster walk tested every slot of
//      its last stage, culled triangles and padding included.
//   3. The gather overlaps the tests. Every thread gathers a share of the
//      next stage's raw rows (9 floats a slot, cp.async into the second of
//      two buffers) while the current stage is tested; a stage's rows become
//      staged coefficients (stage_triangle) from shared memory after its
//      vote. In the cluster walk `chunk` threads gathered, two dependent
//      loads each, while the rest waited at the barrier, with a single
//      buffer. The soup is a few hundred kB, in L2, and other resident
//      blocks hide a gather's latency as well: waiting for the gather before
//      the tests measured the same.
//   4. The card is filled longest walk first. The host hands the tiles in
//      order of their real counts, most first, and a tile's blocks launch in
//      that order: the longest walks start in the first round of resident
//      blocks and the short ones fill the last. The block scheduler hands out
//      blocks in launch order, so a persistent grid with a counter would do
//      the same with more code. In index order the ragged walks left a long
//      tail: 18-45% more time on path D's three uses of B4.
// The wrapper (render/tri_kernel.py::tri_first_hit) routes the tile tiers
// here; chip_smoke.py phase 3 holds the result to the cluster walk at k = 1
// (t and hit to the bit, ids wherever a ray hits).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tri_body.cuh"

namespace {

constexpr int kThreads = 256;                 // threads a block
constexpr int kRays = 2;                      // rays a thread
constexpr int kBlockRays = kThreads * kRays;  // rays a block
constexpr int kParts = kTile / kBlockRays;    // blocks a tile
constexpr int kRawFloats = kMaxChunk * 9;     // a stage's raw rows
static_assert(kTile % kBlockRays == 0, "a block takes an equal share of a tile's rays");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The raw rows of a stage's first m slots into dst, every thread of the block
// a share: float f is component f % 9 of slot f / 9. A slot with no triangle
// gets a zero row, which never hits in either body. The rows have landed
// after cp.async.wait_group 0 and a barrier. One float at a time: the ids'
// loads hit L1 after the first, and reading a thread's share of ids into
// registers before its copies took 96 (kSV) and 124 (kMT) registers a thread
// at 128 threads, where the walk needs half that.
__device__ __forceinline__ void gather(float* __restrict__ dst, const int* __restrict__ ids,
                                       int m, const float* __restrict__ soup, int T) {
#pragma unroll 1
  for (int f = threadIdx.x; f < 9 * m; f += kThreads) {
    const int j = f / 9, id = ids[j];
    if (id >= 0 && id < T)
      cp_async4(dst + f, soup + (size_t)id * 9 + (f - 9 * j));
    else
      dst[f] = 0.0f;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// No bound on the blocks an SM: tri_tile_occupancy reports what ptxas gave.
template <int FORM>
__global__ void __launch_bounds__(kThreads)
tri_tile_kernel(const float* __restrict__ tris,     // (S, T, 9)
                const int* __restrict__ list,       // (S, tiles, n_stage * chunk) triangle ids
                const int* __restrict__ nst,        // (S, tiles) stages to walk
                const int* __restrict__ cnt,        // (S, tiles) real slots
                const float* __restrict__ lb,       // (S, tiles, n_stage) a stage's lower bound
                const int* __restrict__ order,      // S * tiles tiles in launch order, or null
                const float* __restrict__ origins,  // (3, S, R)
                const float* __restrict__ dirs,     // (3, S, R)
                float* __restrict__ t_out, bool* __restrict__ hit_out,
                int* __restrict__ gid_out, int S, int T, int R, int n_stage, int chunk,
                float max_depth) {
  __shared__ float raw[2][kRawFloats];    // raw rows, stages ci and ci + 1 in turn
  __shared__ float4 rows[kMaxChunk * 3];  // the stage being tested, staged

  const int tiles = R / kTile;
  const int item = blockIdx.x / kParts, part = blockIdx.x % kParts;
  const size_t tile_idx = order != nullptr ? (size_t)order[item] : (size_t)item;
  const size_t s = tile_idx / tiles, ti = tile_idx % tiles;
  const size_t plane = (size_t)S * R;
  const size_t ray_base = s * R + ti * kTile;
  const size_t ray0 = ray_base + (size_t)part * kBlockRays + threadIdx.x;
  const int* tile_list = list + tile_idx * n_stage * chunk;
  const float* tile_lb = lb + tile_idx * n_stage;
  const float* soup = tris + s * T * 9;
  const int n_real = max(0, min(cnt[tile_idx], min(nst[tile_idx], n_stage) * chunk));
  const int n_walk = (n_real + chunk - 1) / chunk;

  V3 o_tile = {0.f, 0.f, 0.f};
  if (FORM == kSV)  // ray 0 of the tile
    o_tile = {origins[ray_base], origins[plane + ray_base], origins[2 * plane + ray_base]};

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
  }

  if (n_walk > 0) gather(raw[0], tile_list, min(chunk, n_real), soup, T);
  for (int ci = 0; ci < n_walk; ++ci) {
    const float bound = tile_lb[ci];
    bool open = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) open = open || bound < fminf(tbest[k], max_depth);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's share of stage ci
    // a barrier as well: every share of stage ci's rows has landed, and every
    // thread is done with the rows last tested and with the buffer that the
    // next gather fills (stage ci - 1's)
    const bool run = __syncthreads_or(open);
    if (ci + 1 < n_walk)
      gather(raw[(ci + 1) & 1], tile_list + (size_t)(ci + 1) * chunk,
             min(chunk, n_real - (ci + 1) * chunk), soup, T);
    if (!run) continue;
    const int m = min(chunk, n_real - ci * chunk);
    for (int j = threadIdx.x; j < m; j += kThreads)
      stage_triangle<FORM>(rows + 3 * j, raw[ci & 1] + 9 * j, o_tile);
    __syncthreads();

    const int pos0 = ci * chunk;
    for (int j = 0; j < m; ++j) {
      const float4 r0 = rows[3 * j], r1 = rows[3 * j + 1], r2 = rows[3 * j + 2];
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        test_slot<FORM>(r0, r1, r2, dx[k], dy[k], dz[k], ox[k], oy[k], oz[k], pos0 + j,
                        tbest[k], pbest[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t idx = ray0 + (size_t)k * kThreads;
    const float t = fminf(fmaxf(tbest[k], 0.0f), max_depth);
    t_out[idx] = t;
    hit_out[idx] = t < max_depth;
    gid_out[idx] = pbest[k] >= 0 ? tile_list[pbest[k]] : 0;
  }
}

using TileKernel = void (*)(const float*, const int*, const int*, const int*, const float*,
                            const int*, const float*, const float*, float*, bool*, int*, int,
                            int, int, int, int, float);

TileKernel tile_kernel_of(int form) {
  if (form == kMT) return tri_tile_kernel<kMT>;
  if (form == kSV) return tri_tile_kernel<kSV>;
  return nullptr;
}

}  // namespace

// form: 0 Moller-Trumbore, 1 signed volumes against ray 0 of each tile. R must
// be a multiple of 1,024 and chunk at most 128; list holds n_stage stages of
// chunk triangle ids a tile (-1: none), cnt each tile's real slots. order
// null: the tiles in index order; else the S * tiles tile indices (s * tiles +
// tile) in the order their blocks launch. Returns the CUDA error of the
// launch (0: none).
extern "C" int tri_tile_launch(const float* tris, const int* list, const int* nst,
                               const int* cnt, const float* lb, const int* order,
                               const float* origins, const float* dirs, float* t_out,
                               bool* hit_out, int* gid_out, int S, int T, int R, int n_stage,
                               int chunk, float max_depth, int form, cudaStream_t stream) {
  const TileKernel kernel = tile_kernel_of(form);
  const long long blocks = (long long)S * (R / kTile) * kParts;
  if (kernel == nullptr || S < 0 || R < 0 || R % kTile != 0 || chunk < 1 ||
      chunk > kMaxChunk || n_stage < 1 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  if (form == kMT)
    tri_tile_kernel<kMT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tris, list, nst, cnt, lb, order, origins, dirs, t_out, hit_out, gid_out, S, T, R, n_stage,
        chunk, max_depth);
  else
    tri_tile_kernel<kSV><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tris, list, nst, cnt, lb, order, origins, dirs, t_out, hit_out, gid_out, S, T, R, n_stage,
        chunk, max_depth);
  return (int)cudaGetLastError();
}

// What the card holds of the kernel of `form`: registers a thread, threads and
// rays a block, blocks an SM. Returns the CUDA error (0: none).
extern "C" int tri_tile_occupancy(int form, int* regs, int* threads, int* rays,
                                  int* blocks_per_sm) {
  const TileKernel kernel = tile_kernel_of(form);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *threads = kThreads;
  *rays = kBlockRays;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0);
}
