// Stage 3 of the VCM eye passes: the merge and the ordered gather, one
// thread per path (tpt::eye_gather_one, eye.cuh), in the classic and K14's
// VCM and BDPT flavours. No ray is traced here.
//
// Replaces the per-lane sums of cudapathtracer_tpu/models/vcm.py:
// render_sample's eye pass (line 150) with ops/hashgrid.py:fold_neighbors
// (240), and the merge and retirement of models/vcm_mega.py:
// _mk_eye_machine (322) (neighbor_slots, cap <= 8; RGB9E5) and of
// models/bdpt_mega.py:render_sample (56).
//
// Bound: the records, terms and connection contributions of the depths
// each path reached (108 + 12 light_rows bytes a vertex), and under the
// merge 8 (start, end) reads and up to 8 x cap scattered 32-byte photon
// rows per vertex with three BSDF evaluations per photon in range: memory
// latency. Design: one thread adds its path's terms in the flavour's JAX
// order into a register sum from zero (the fused pass's float32 additions
// in its order, so the pixel does not move), depth-major reads coalesced
// across the warp, the grid through the L1/L2 caches; it exits at the
// walk's last record. ptxas (H100 build): 80 registers with 12 (classic)
// and 28-40 (mega) bytes of spills beside the query's 64-byte cell table,
// 32 under BDPT (no merge).

#include <cuda_runtime.h>

#include <cstdint>

#include "eye.cuh"

namespace {

constexpr int kThreads = 128;

template <int kFlavor>
__global__ void __launch_bounds__(kThreads)
    eye_gather_kernel(tpt::EyeLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  tpt::eye_gather_one<kFlavor>(c, i);
}

}  // namespace

// The argument layout is eye.cuh's (tpt::eye_launch). Returns the launch's
// cudaError_t.
extern "C" int tpt_eye_gather(const int64_t* ptrs, const int64_t* iv,
                              const float* fv, const uint32_t* keys,
                              void* stream) {
  tpt::EyeLaunch c;
  if (!tpt::eye_launch(ptrs, iv, fv, keys, c) || c.out == nullptr ||
      c.dropped == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace tpt;
  if (c.flavor == kEyeMegaVcm)
    eye_gather_kernel<kEyeMegaVcm><<<blocks, kThreads, 0, st>>>(c);
  else if (c.flavor == kEyeMegaBdpt)
    eye_gather_kernel<kEyeMegaBdpt><<<blocks, kThreads, 0, st>>>(c);
  else
    eye_gather_kernel<kEyeClassic><<<blocks, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
