// K11: the t=1 light-trace splat, in its BDPT and VCM forms, as two
// stages: classify and bin the light vertices that trace, then one shadow
// ray a thread in screen-tile order.
//
// bdpt_splat replaces cudapathtracer_tpu/models/bdpt.py:light_trace_splat
// (line 93); its VCM mode (iv vcm) replaces models/vcm.py:vcm_light_splat
// (line 87), which splats only the stored vertices (not the endpoint) and
// adds eta_vcm to each vertex's w_light (SplatParams::vcm).
// Every light vertex (the unpacked endpoint s=1 and the stored vertices
// s>=2, decoded through K10) is projected onto the image
// (tpt::world_to_raster), tested for visibility with a shadow ray to the
// lens (K1, or K15 on a threaded scene), weighted by We G f and its MIS
// weight (tpt::splat_vertex, bdpt.cuh), and added into the frame buffer
// with atomicAdd where XLA scatter-adds. The raster index is truncated,
// then clipped, as there. Float atomics make each pixel's sum
// order-nondeterministic.
//
// Why two stages: one thread per light vertex (j, i) gave a warp vertex j
// of 32 consecutive light paths, which land anywhere in the scene, so its
// shadow rays started at scattered points and its atomics hit scattered
// pixels; and about 42% of the threads traced nothing (invalid, delta or
// off screen). Rays from nearby surface points to one pinhole are nearly
// parallel: grouped by the screen tile they project to, a warp's rays
// traverse like a bundle of primary rays in reverse, and its atomics land
// in one tile.
//
//   1. classify and bin (stage 1; three kernels and a memset), a
//      counting sort: no torch.sort, no host sync. splat_classify_kernel
//      runs one thread per light path i < n_live over its rows (coalesced
//      reads of valid, flags and pt) on a grid of bin_blocks, finds each
//      vertex's tile or -1 (tpt::splat_tile, the test splat_vertex makes
//      before its ray), takes its rank among its block's entries of that
//      tile from a shared-memory histogram, writes (rank, tile) to tile_of
//      [rows, N] and adds the traced count to rays[i]; at its end each
//      block reserves its part of every tile it holds entries of with one
//      atomicAdd to the global count (block_base); splat_scan_kernel, one
//      block, turns the counts into offsets (offsets[tiles]: the queue's
//      length); splat_scatter_kernel, on the same grid and the same paths
//      a thread, writes each traced entry r N + i to queue[offsets[tile] +
//      block_base[block, tile] + rank], without atomics.
//   2. trace and splat (stage 2): splat_trace_kernel, one thread per
//      queue slot, the grid from the upper bound rows x n_live with an
//      early exit past the length the card holds, runs splat_vertex
//      unchanged (the same shadow ray, so visibility matches the plain
//      version) on entry queue[q].
//
// Bound: the shadow rays' traversal (memory latency), then the atomics.

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBinThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kMaxTiles = 8192;  // the histogram in shared memory (32 KB)
constexpr int kTileBits = 13;    // a bin code: rank << 13 | tile

__device__ __forceinline__ int rows_of(const tpt::SplatLaunch& s) {
  return s.lb.depth + (s.p.vcm ? 0 : 1);  // VCM splats no endpoint
}

// One thread a light path i < n_live over its rows, on bin_blocks blocks
// (the scatter kernel maps paths to threads the same way): each entry's
// bin code (rank << kTileBits | tile, or -1) into tile_of, the traced
// count into rays[i], then the block's part of each tile reserved.
__global__ void __launch_bounds__(kBinThreads)
splat_classify_kernel(tpt::SplatLaunch s) {
  __shared__ int32_t hist[kMaxTiles];
  for (int t = threadIdx.x; t < s.tiles; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int first = s.p.vcm ? 1 : 0;
  const int rows = rows_of(s);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < s.n_live; i += stride) {
    int32_t traced = 0;
    for (int r = 0; r < rows; ++r) {
      const int32_t t =
          tpt::splat_tile(s.p, s.lb, s.e, r + first, i, s.tile, s.tiles_x);
      int32_t code = -1;
      if (t >= 0) {
        code = (atomicAdd(&hist[t], 1) << kTileBits) | t;
        ++traced;
      }
      s.tile_of[r * s.n + i] = code;
    }
    s.rays[i] += traced;
  }
  __syncthreads();
  int32_t* base = s.block_base + static_cast<int64_t>(blockIdx.x) * s.tiles;
  for (int t = threadIdx.x; t < s.tiles; t += blockDim.x)
    base[t] = hist[t] != 0 ? atomicAdd(s.hist + t, hist[t]) : 0;
}

// Exclusive prefix sums of the tile counts, one block: offsets, and
// offsets[tiles] the total.
__global__ void __launch_bounds__(kScanThreads)
splat_scan_kernel(tpt::SplatLaunch s) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int per = (s.tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = t0 + per < s.tiles ? t0 + per : s.tiles;
  int32_t own = 0;
  for (int t = t0; t < t1; ++t) own += s.hist[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = own;  // inclusive scan over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int32_t base = x - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int t = t0; t < t1; ++t) {
    s.offsets[t] = base;
    base += s.hist[t];
  }
  if (threadIdx.x == kScanThreads - 1) s.offsets[s.tiles] = base;
}

// Each traced entry k = r N + i (row r of path i) into its slot of the
// queue, on the classify kernel's grid and mapping.
__global__ void __launch_bounds__(kBinThreads)
splat_scatter_kernel(tpt::SplatLaunch s) {
  const int rows = rows_of(s);
  const int32_t* base =
      s.block_base + static_cast<int64_t>(blockIdx.x) * s.tiles;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < s.n_live; i += stride) {
    for (int r = 0; r < rows; ++r) {
      const int64_t k = r * s.n + i;
      const int32_t code = s.tile_of[k];
      if (code < 0) continue;
      const int32_t t = code & (kMaxTiles - 1);
      s.queue[s.offsets[t] + base[t] + (code >> kTileBits)] =
          static_cast<int32_t>(k);
    }
  }
}

template <int kEngine>
__global__ void __launch_bounds__(kThreads)
splat_trace_kernel(tpt::SplatLaunch s) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= s.offsets[s.tiles]) return;
  const int64_t k = s.queue[q];
  const int j = static_cast<int>(k / s.n) + (s.p.vcm ? 1 : 0);
  tpt::splat_vertex<kEngine>(s.sc, s.p, s.lb, s.e, j, k % s.n, s.fb,
                             s.rows);
}

}  // namespace

// ptrs: table, tri_f32, mat_f32, textures, the 11 light-buffer fields,
// v0_pt, v0_n, v0_beta, v0_pdf, v0_mat (0 in VCM's form), fb, rays, rows
// (0 = none), the threaded tables (0 under BVH8), then the stages' scratch:
// tile_of [rows, N] i32, queue [rows, N] i32, tables [2 tiles + 1] i32
// (the counts, the offsets) and block_base [bin_blocks, tiles] i32. iv:
// n, tri_cols, depth (stored light vertices), width, height, do_mis,
// paint_weight, vcm, n_live (paths i >= n_live are skipped: the mega
// engines' chunk pads), engine, bin nodes, bin slots, tile (pixels a
// side), tiles_x, tiles (at most 8192), bin_blocks (the classify grid: each
// block holds fewer than 2^18 entries), stages (1: classify and bin, 2:
// trace and splat, on the queue of an earlier stage 1 on the same
// scratch). rows = depth + 1 in the BDPT form, depth in VCM's;
// rows x N < 2^31. fv: the 19 camera floats, plane_area, eta_vcm.
// Returns the launches' cudaError_t.
extern "C" int tpt_bdpt_splat(const int64_t* ptrs, const int64_t* iv,
                              const float* fv, void* stream) {
  tpt::SplatLaunch s;
  if (!tpt::splat_launch(ptrs, iv, fv, s) || s.tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = s.lb.depth + (s.p.vcm ? 0 : 1);
  const int64_t total = rows * s.n;
  if (total >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t live = rows * s.n_live;
  // a bin code's rank needs fewer than 2^18 entries a classify block
  const int64_t per_block =
      (s.n_live + int64_t{s.bin_blocks} * kBinThreads - 1) /
      (int64_t{s.bin_blocks} * kBinThreads) * kBinThreads * rows;
  if (per_block >= (int64_t{1} << (31 - kTileBits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.stages == 1) {
    cudaError_t err =
        cudaMemsetAsync(s.hist, 0, sizeof(int32_t) * s.tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>(s.bin_blocks);
    if (live > 0) splat_classify_kernel<<<blocks, kBinThreads, 0, st>>>(s);
    splat_scan_kernel<<<1, kScanThreads, 0, st>>>(s);
    if (live > 0) splat_scatter_kernel<<<blocks, kBinThreads, 0, st>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.stages == 2 && live > 0) {
    const unsigned blocks =
        static_cast<unsigned>((live + kThreads - 1) / kThreads);
    if (s.engine == tpt::kEngineThreaded)
      splat_trace_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(
          s);
    else
      splat_trace_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}
