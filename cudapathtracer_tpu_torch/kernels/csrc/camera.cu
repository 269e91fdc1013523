// K7: primary ray generation (pinhole and thin lens).
//
// Replaces cudapathtracer_tpu/scene/camera.py:Camera.generate_rays
// (lines 81-110) as the classic integrator calls it: four id-keyed draws
// per pixel (0, 1: +-0.5 * aa_jitter tent jitter; 2, 3: lens disk), the
// focal-plane point, the lens offset gated on aperture > 0, and the
// normalized direction.
//
// Bound: 4 Threefry draws (~200 integer ops) and a few dozen float ops per
// pixel against 12 bytes read and 24 written, so ALU throughput bounds it.
// Design: one thread per pixel; the camera and the four draw keys (folded on
// the host) arrive by value in one struct, so the kernel reads only px, py
// and the ids. Pinhole and thin lens share one code path, as in the JAX
// function. The arithmetic follows the plain PyTorch version operation for
// operation (the file is built with -fmad=false) so the two agree to
// rounding; rsqrtf mirrors torch.rsqrt on the GPU.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

struct CameraParams {
  float origin[3], right[3], up[3], forward[3];
  float fov_scale, aperture, focal_dist, aspect, width, height, aa_jitter;
  uint32_t keys[8];  // (k0, k1) of draws 0, 1, 2, 3
};

__global__ void generate_rays_kernel(const float* __restrict__ px,
                                     const float* __restrict__ py,
                                     const int32_t* __restrict__ ids,
                                     float* __restrict__ o_out,
                                     float* __restrict__ d_out, int64_t n,
                                     CameraParams c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t id = static_cast<uint32_t>(ids[i]);
  const float jx = tpt::uniform_draw_key(c.keys[0], c.keys[1], id) - 0.5f;
  const float jy = tpt::uniform_draw_key(c.keys[2], c.keys[3], id) - 0.5f;
  const float u =
      (2.0f * (px[i] + jx * c.aa_jitter) / c.width - 1.0f) * c.aspect *
      c.fov_scale;
  const float v =
      (2.0f * (py[i] + jy * c.aa_jitter) / c.height - 1.0f) * c.fov_scale;
  const float uf = u * c.focal_dist;
  const float vf = v * c.focal_dist;

  const float r_rnd = tpt::uniform_draw_key(c.keys[4], c.keys[5], id);
  const float theta =
      6.28318530717958647692f *
      tpt::uniform_draw_key(c.keys[6], c.keys[7], id);
  const float radius = c.aperture * sqrtf(r_rnd);
  const float rc = radius * cosf(theta);
  const float rs = radius * sinf(theta);
  const bool lens_on = c.aperture > 0.0f;

  float org[3], dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float focal =
        c.origin[k] + c.right[k] * uf + c.up[k] * vf + c.forward[k] * c.focal_dist;
    const float lens = lens_on ? c.right[k] * rc + c.up[k] * rs : 0.0f;
    org[k] = c.origin[k] + lens;
    dir[k] = focal - org[k];
  }
  const float l2 = dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2];
  const float inv = rsqrtf(fmaxf(l2, 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_out[3 * i + k] = org[k];
    d_out[3 * i + k] = dir[k] * inv;
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
  CameraParams c;
  for (int k = 0; k < 3; ++k) {
    c.origin[k] = params[k];
    c.right[k] = params[3 + k];
    c.up[k] = params[6 + k];
    c.forward[k] = params[9 + k];
  }
  c.fov_scale = params[12];
  c.aperture = params[13];
  c.focal_dist = params[14];
  c.aspect = params[15];
  c.width = params[16];
  c.height = params[17];
  c.aa_jitter = params[18];
  for (int k = 0; k < 8; ++k) c.keys[k] = keys[k];
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  generate_rays_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(px, py, ids, o,
                                                              d, n, c);
  return static_cast<int>(cudaGetLastError());
}
