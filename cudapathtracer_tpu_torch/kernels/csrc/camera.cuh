// K7 device code: one pixel's primary ray (pinhole and thin lens).
//
// Replaces cudapathtracer_tpu/scene/camera.py:Camera.generate_rays (lines
// 81-110) and its lane-major twin ops/lanemajor.py:generate_raysT (line 677),
// which the mega engine calls on refill: id-keyed draws 0, 1 (the +-0.5 *
// aa_jitter jitter), the focal-plane point, the lens offset gated on aperture >
// 0 (draws 2, 3: the disk point), and the normalized direction. The JAX
// function always draws the disk and then discards the offset at aperture 0;
// here the lens (two ciphers, sqrtf and one sincosf) runs only when aperture >
// 0, a branch uniform across the launch, so a camera of aperture 0 takes two
// draws and no lens arithmetic. (The reference's pinhole factory, which
// "Pinhole Camera: true" selects, sets aperture 1e-6: its lens is live.)
// forward * focal_dist is the same product for every pixel and is taken once in
// make_camera. camera.cu launches it over a batch of pixels; uni_mega.cu and
// the BDPT eye walk (bdpt_walk.cu) call it at the start of each path. Also
// world_to_raster (scene/camera.py:112), the light-trace splat's projection
// (bdpt_splat.cu).
//
// The arithmetic follows the plain PyTorch version operation for operation
// (every including file is built with -fmad=false), so the two agree to
// rounding; rsqrtf mirrors torch.rsqrt on the GPU.
#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace tpt {

struct CameraParams {
  float origin[3], right[3], up[3], forward[3];
  float fov_scale, aperture, focal_dist, aspect, width, height, aa_jitter;
  float forward_focal[3];  // forward * focal_dist
  uint32_t keys[8];  // (k0, k1) of draws 0, 1, 2, 3
};

// params: origin[3], right[3], up[3], forward[3], fov_scale, aperture,
// focal_dist, aspect, width, height, aa_jitter (19 floats); keys: 8 words.
__host__ __device__ inline CameraParams make_camera(const float* params,
                                                    const uint32_t* keys) {
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
  for (int k = 0; k < 3; ++k) c.forward_focal[k] = c.forward[k] * c.focal_dist;
  for (int k = 0; k < 8; ++k) c.keys[k] = keys[k];
  return c;
}

// The primary ray of pixel (px, py) with draws keyed by id under the
// draw-key words keys[0..7] (c.keys, or a sample's row of K5's key table).
__device__ __forceinline__ void camera_ray(const CameraParams& c,
                                           const uint32_t* keys, float px,
                                           float py, uint32_t id,
                                           float org[3], float dir[3]) {
  const float jx = uniform_draw_key(keys[0], keys[1], id) - 0.5f;
  const float jy = uniform_draw_key(keys[2], keys[3], id) - 0.5f;
  const float u =
      (2.0f * (px + jx * c.aa_jitter) / c.width - 1.0f) * c.aspect *
      c.fov_scale;
  const float v =
      (2.0f * (py + jy * c.aa_jitter) / c.height - 1.0f) * c.fov_scale;
  const float uf = u * c.focal_dist;
  const float vf = v * c.focal_dist;

  // the lens disk: rc = radius cos(theta), rs = radius sin(theta)
  float rc = 0.0f, rs = 0.0f;
  const bool lens_on = c.aperture > 0.0f;
  if (lens_on) {
    const float r_rnd = uniform_draw_key(keys[4], keys[5], id);
    const float theta =
        6.28318530717958647692f * uniform_draw_key(keys[6], keys[7], id);
    const float radius = c.aperture * sqrtf(r_rnd);
    float sn, cs;
    sincosf(theta, &sn, &cs);
    rc = radius * cs;
    rs = radius * sn;
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float focal = c.origin[k] + c.right[k] * uf + c.up[k] * vf +
                        c.forward_focal[k];
    const float lens = lens_on ? c.right[k] * rc + c.up[k] * rs : 0.0f;
    org[k] = c.origin[k] + lens;
    dir[k] = focal - org[k];
  }
  const float l2 = dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2];
  const float inv = rsqrtf(fmaxf(l2, 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = dir[k] * inv;
}

// The primary ray of pixel (px, py) with draws keyed by id.
__device__ __forceinline__ void camera_ray(const CameraParams& c, float px,
                                           float py, uint32_t id,
                                           float org[3], float dir[3]) {
  camera_ray(c, c.keys, px, py, id, org, dir);
}

// The light tracer's sensor (scene/camera.py world_to_raster): the pixel
// coordinates (rx, ry) of world point p; false when p is behind the lens
// (depth <= 0.001) or off the image.
__device__ __forceinline__ bool world_to_raster(const CameraParams& c,
                                                const float p[3], float& rx,
                                                float& ry) {
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = p[k] - c.origin[k];
  const float dist_z =
      d[0] * c.forward[0] + d[1] * c.forward[1] + d[2] * c.forward[2];
  bool ok = dist_z > 0.001f;
  const float safe_z = ok ? dist_z : 1.0f;
  const float slope_x =
      (d[0] * c.right[0] + d[1] * c.right[1] + d[2] * c.right[2]) / safe_z;
  const float slope_y =
      (d[0] * c.up[0] + d[1] * c.up[1] + d[2] * c.up[2]) / safe_z;
  const float ndc_x = slope_x / (c.aspect * c.fov_scale);
  const float ndc_y = slope_y / c.fov_scale;
  ok = ok && fabsf(ndc_x) <= 1.0f && fabsf(ndc_y) <= 1.0f;
  rx = (ndc_x + 1.0f) * 0.5f * c.width;
  ry = (ndc_y + 1.0f) * 0.5f * c.height;
  return ok;
}

}  // namespace tpt
