// K7: primary ray generation (pinhole and thin lens), one launch per batch
// of pixels.
//
// Replaces cudapathtracer_tpu/scene/camera.py:Camera.generate_rays
// (lines 81-110) for a batch of pixels. The per-pixel arithmetic is
// tpt::camera_ray (camera.cuh), shared with the hosts that start paths
// (uni_mega.cu, bdpt_walk.cu, eye_walk.cu).
//
// Bound: 12 bytes read and 24 written a pixel against two Threefry draws
// at aperture 0 (about 80 SASS integer instructions each, on the INT32
// pipe's 64 lanes a clock an SM) or four and the lens's sqrtf and sincosf
// at aperture > 0, and a few dozen float ops: at 1080p the bytes bound it
// by a little at aperture 0, the integer work at aperture > 0.
// Design: one thread per pixel; the camera and the four draw keys (folded on
// the host) arrive by value in one struct, so the kernel reads only px, py
// and the ids. The lens is a branch uniform across the launch: a camera of
// aperture 0 skips its draws and arithmetic, whose offset the JAX function
// discards there.

#include <cuda_runtime.h>

#include <cstdint>

#include "camera.cuh"

namespace {

__global__ void generate_rays_kernel(const float* __restrict__ px,
                                     const float* __restrict__ py,
                                     const int32_t* __restrict__ ids,
                                     float* __restrict__ o_out,
                                     float* __restrict__ d_out, int64_t n,
                                     tpt::CameraParams c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  float org[3], dir[3];
  tpt::camera_ray(c, px[i], py[i], static_cast<uint32_t>(ids[i]), org, dir);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_out[3 * i + k] = org[k];
    d_out[3 * i + k] = dir[k];
  }
}

}  // namespace

// params: origin[3], right[3], up[3], forward[3], fov_scale, aperture,
// focal_dist, aspect, width, height, aa_jitter (19 floats, host memory);
// keys: 8 uint32 (host memory). Returns the launch's cudaError_t.
extern "C" int tpt_generate_rays(const float* px, const float* py,
                                 const int32_t* ids, float* o, float* d,
                                 int64_t n, const float* params,
                                 const uint32_t* keys, void* stream) {
  if (n <= 0) return 0;
  const tpt::CameraParams c = tpt::make_camera(params, keys);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  generate_rays_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(px, py, ids, o,
                                                              d, n, c);
  return static_cast<int>(cudaGetLastError());
}
