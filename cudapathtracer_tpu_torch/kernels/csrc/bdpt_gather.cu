// K13, stage 2 of 2: the ordered gather of the BDPT connection stage, one
// thread per pixel (tpt::gather_pixel, bdpt.cuh). No ray is traced here.
//
// Replaces the environment term, the s = 0 strategy and the sums of
// cudapathtracer_tpu/models/bdpt.py:render_sample's connection stage (226,
// lines 258-441), with the splat's frame buffer added (li + fb).
//
// Bound: the eye vertices each pixel reached (51 bytes each, K12's packed
// buffers), its terms (12 bytes a slot of those depths) and fb read, 12
// bytes written: memory bandwidth. Design: one thread adds its pixel's
// terms into a register sum from zero, in the order of the per-pixel loop
// that bdpt_pairs.cu and this kernel replaced (so the pixel does not
// move); depth-major reads are coalesced across the warp, and the thread
// stops at the pixel's first invalid eye vertex. It traces nothing, so it
// is built once, not per traversal engine (as eye_gather.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    bdpt_gather_kernel(tpt::ConnectLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  tpt::put3(c.out, i, tpt::gather_pixel(c, i));
}

}  // namespace

// The argument layout is tpt_bdpt_pairs' (bdpt_pairs.cu; per is not read).
// The gather reads
// the eye buffers, ev0_pt, the escape, terms and fb (0 = none) and writes
// out; px, py, the light buffers, rays and rows may be 0. Returns the
// launch's cudaError_t.
extern "C" int tpt_bdpt_gather(const int64_t* ptrs, const int64_t* iv,
                               const float* fv, const uint32_t* keys,
                               void* stream) {
  tpt::ConnectLaunch c;
  if (!tpt::connect_launch(ptrs, iv, fv, keys, c) || c.out == nullptr ||
      c.in.ev0_pt == nullptr || c.in.esc_valid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  bdpt_gather_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}
