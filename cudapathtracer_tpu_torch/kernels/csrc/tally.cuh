// The device counters of a traced run (utils/metrics.py COUNTERS): the
// VCM eye passes' walk and connection stages (eye.cuh) add their rows and
// rays into a nullable int64 buffer. The lanes that call together sum
// their values in registers and the group's first lane adds the sums, one
// atomic a word, so a warp's work costs one atomic a word however many of
// its lanes call. Every call sits behind the kernel's null test of the
// buffer. (K5's counter is the sum of its per-pixel rows and rays
// outputs, reduced after the launch: kernels.render_unidirectional.)

#pragma once

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>

#include <cstdint>

namespace tpt {

// tally[0] += rows and tally[1] += rays summed over the calling lanes; with
// call, tally[2] += 1 for them all (the lanes that call together count
// once, as persistent.cuh's calls).
__device__ __forceinline__ void tally_add(unsigned long long* tally,
                                          int32_t rows, int32_t rays,
                                          bool call) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  const uint32_t sr =
      cg::reduce(g, static_cast<uint32_t>(rows), cg::plus<uint32_t>());
  const uint32_t sy =
      cg::reduce(g, static_cast<uint32_t>(rays), cg::plus<uint32_t>());
  if (g.thread_rank() == 0) {
    atomicAdd(tally, static_cast<unsigned long long>(sr));
    atomicAdd(tally + 1, static_cast<unsigned long long>(sy));
    if (call) atomicAdd(tally + 2, 1ull);
  }
}

}  // namespace tpt
