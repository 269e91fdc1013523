// Persistent threads with per-lane path regeneration, shared by K5
// (uni_mega.cu) and K12 (bdpt_walk.cu): the grid is the blocks that fit on
// the card at once, a lane whose path ends takes the next id from a device
// counter, and optional lane counters say how busy the lanes were.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpt {

// The next id: one atomicAdd for the lanes that ask together, which take
// consecutive ids.
__device__ __forceinline__ int64_t next_id(unsigned long long* counter) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, g.size());
  return static_cast<int64_t>(g.shfl(base, 0) + g.thread_rank());
}

// lanes (nullable) += (events stepped, the sum over warps of the warp's
// busiest lane's events, the warps' calls of the event code: the lanes that
// call it together count once), whose ratios events / (32 x calls) and
// events / (32 x busiest) are the lane use and the event balance. Every
// thread of the block calls it (it syncs the block).
template <int kThreads>
__device__ __forceinline__ void add_lane_counts(int32_t events, int32_t calls,
                                                unsigned long long* lanes) {
  constexpr int kWarps = kThreads / 32;
  if (lanes == nullptr) return;
  __shared__ int32_t warp_max[kWarps];
  __shared__ unsigned long long block_sums[2];
  if (threadIdx.x < kWarps) warp_max[threadIdx.x] = 0;
  if (threadIdx.x < 2) block_sums[threadIdx.x] = 0;
  __syncthreads();
  atomicMax(&warp_max[threadIdx.x / 32], events);
  atomicAdd(&block_sums[0], static_cast<unsigned long long>(events));
  atomicAdd(&block_sums[1], static_cast<unsigned long long>(calls));
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long busiest = 0;
    for (int w = 0; w < kWarps; ++w) busiest += warp_max[w];
    atomicAdd(lanes, block_sums[0]);
    atomicAdd(lanes + 1, busiest);
    atomicAdd(lanes + 2, block_sums[1]);
  }
}

// The persistent grid of Kernel (blocks of kThreads) for n ids on the
// current device: its SMs times the blocks that fit on one, queried once a
// device, and at most one block a kThreads ids. Returns a cudaError_t.
template <auto Kernel, int kThreads>
int resident_grid(int64_t n, unsigned& blocks) {
  constexpr int kDevices = 64;
  static int per_sm[kDevices], sms[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int nb = 0, count = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, Kernel, kThreads,
                                                        0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1 || count < 1) return cudaErrorLaunchOutOfResources;
    sms[dev] = count;
    per_sm[dev] = nb;
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms[dev]) * per_sm[dev];
  blocks = static_cast<unsigned>(need < full ? need : full);
  return 0;
}

}  // namespace tpt
