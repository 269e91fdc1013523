// Stage 2 of the VCM eye passes: the connections (s >= 2), one thread per
// (eye depth t, light row j, path i) (tpt::eye_connect_one, eye.cuh), in
// the classic VCM flavour on the scene's engine and in K14's VCM and BDPT
// flavours on BVH8. SPPM and any pass with the connections off do not
// launch it.
//
// Replaces the connections of cudapathtracer_tpu/models/vcm.py:
// render_sample's eye pass (line 150) and of models/vcm_mega.py:
// _mk_eye_machine (322) with _pack_conn_table (148), and of
// models/bdpt_mega.py:render_sample (56).
//
// Bound: one shadow ray per traced pair (dependent BVH8 row fetches:
// memory latency), the eye record (84 bytes) and the light vertex (51
// bytes, K12's packed buffers) read, 12 bytes written per pair. Design:
// one shadow ray a thread, no loop whose length varies from lane to lane;
// blockIdx.y is the pair (t, j) and a warp holds 32 neighbouring paths of
// it, so the depth-major records, light buffers and outputs are read and
// written coalesced, and a warp whose eye vertices are dead, delta or
// invalid leaves before it fetches a light vertex. The rays and rows are
// integer atomics, so their totals stay exact in any order. At least 5
// blocks of 128 threads an SM, the count the threaded instantiation (91
// registers) gets: the BVH8 one then fits in 96 registers with some spill,
// and ran faster than at 4 blocks (124 registers, no spill;
// tools/k1_attribution.py, PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "eye.cuh"

namespace {

constexpr int kThreads = 128;
// At a minimum of kMinBlocks blocks of 128 an SM (64 registers, spills
// cached): the connection's lobes read by id and evaluated once a side
// leave few live values, and the warps pay (a 1080p VCM sample's
// connections 45.8 ms at 8, 45.7 at 10, 48.8 at 6, 52.6 at 5; H100,
// tools/shade_attribution.py).
constexpr int kMinBlocks = 8;

template <int kFlavor, int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    eye_connect_kernel(tpt::EyeLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  const int tj = static_cast<int>(blockIdx.y);
  tpt::eye_connect_one<kFlavor, kEngine>(c, tj / c.p.light_rows,
                                         tj % c.p.light_rows, i);
}

}  // namespace

// The argument layout is eye.cuh's (tpt::eye_launch); conn (ptrs[39]) is
// required. Returns the launch's cudaError_t.
extern "C" int tpt_eye_connect(const int64_t* ptrs, const int64_t* iv,
                               const float* fv, const uint32_t* keys,
                               void* stream) {
  tpt::EyeLaunch c;
  if (!tpt::eye_launch(ptrs, iv, fv, keys, c) || c.conn == nullptr ||
      c.p.light_rows < 1 ||
      static_cast<int64_t>(c.p.eye_depth) * c.p.light_rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const dim3 blocks(static_cast<unsigned>((c.n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(c.p.eye_depth * c.p.light_rows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace tpt;
  if (c.flavor == kEyeMegaVcm)
    eye_connect_kernel<kEyeMegaVcm, kEngineBvh8>
        <<<blocks, kThreads, 0, st>>>(c);
  else if (c.flavor == kEyeMegaBdpt)
    eye_connect_kernel<kEyeMegaBdpt, kEngineBvh8>
        <<<blocks, kThreads, 0, st>>>(c);
  else if (c.engine == kEngineThreaded)
    eye_connect_kernel<kEyeClassic, kEngineThreaded>
        <<<blocks, kThreads, 0, st>>>(c);
  else
    eye_connect_kernel<kEyeClassic, kEngineBvh8>
        <<<blocks, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
