// K10 device code (codec part): the packed path-vertex codecs.
//
// Replaces cudapathtracer_tpu/utils/packing.py:pack_oct (23), unpack_oct
// (37), to_half3 (92), from_half3 (98), pack_flags (128) and unpack_flags
// (136): the octahedral unit vector in one word (2 x snorm16, x low), the
// half-precision beta and uv, and the flag word (bit 31 isDelta, bit 30
// backface, bits 29..10 lightInd + 1, bits 9..0 materialID). Every BDPT
// vertex goes through them: the walk (bdpt_walk.cu) encodes, the splat and
// the connections (bdpt_splat.cu, bdpt_connect.cu) decode; packing.cu
// launches them over a batch for the comparison with the plain versions.
// Also the RGB9E5 word (below) through which the mega kernels (uni_mega.cu,
// the mega eye pass's gather eye_gather.cu) retire each path's radiance.
//
// Bit parity with the JAX package: snorm16 rounding is round-half-even
// (rintf, as jnp.round); float -> half is __float2half_rn (XLA's convert);
// the decoder's norm is XLA:CPU's contracted sum fma(z, z, fma(y, y, x*x)),
// written with __fmaf_rn because the files are built with -fmad=false.
//
// Bound: a few dozen flops per vector against 4-12 bytes each way, so
// memory in a batch; inside the BDPT kernels it is noise beside a shadow
// ray.
#pragma once

#include <cuda_fp16.h>

#include <cstdint>

#include "shade.cuh"

namespace tpt {

__device__ __forceinline__ uint32_t snorm16(float p) {
  const float q = fminf(fmaxf(rintf(p * 32767.0f), -32767.0f), 32767.0f);
  return static_cast<uint32_t>(static_cast<int32_t>(q)) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t pack_oct(V3 n) {
  const float denom = fabsf(n.x) + fabsf(n.y) + fabsf(n.z);
  const float dd = fmaxf(denom, 1e-20f);
  float px = n.x / dd, py = n.y / dd;
  if (n.z < 0.0f) {  // fold the lower hemisphere over the diamond edges
    const float wx = (1.0f - fabsf(py)) * (px >= 0.0f ? 1.0f : -1.0f);
    const float wy = (1.0f - fabsf(px)) * (py >= 0.0f ? 1.0f : -1.0f);
    px = wx;
    py = wy;
  }
  return snorm16(px) | (snorm16(py) << 16);
}

__device__ __forceinline__ V3 unpack_oct(uint32_t u) {
  int32_t ix = static_cast<int32_t>(u & 0xFFFFu);
  int32_t iy = static_cast<int32_t>((u >> 16) & 0xFFFFu);
  if (ix > 32767) ix -= 65536;
  if (iy > 32767) iy -= 65536;
  const float fx = static_cast<float>(ix) / 32767.0f;
  const float fy = static_cast<float>(iy) / 32767.0f;
  const float z = 1.0f - fabsf(fx) - fabsf(fy);
  const float t = fmaxf(-z, 0.0f);
  const float x = fx - (fx >= 0.0f ? t : -t);
  const float y = fy - (fy >= 0.0f ? t : -t);
  const float s = __fmaf_rn(z, z, __fmaf_rn(y, y, x * x));
  const float len = fmaxf(sqrtf(s), 1e-20f);
  return v3(x / len, y / len, z / len);
}

__device__ __forceinline__ uint32_t pack_flags(bool is_delta, bool backface,
                                               int32_t light_ind,
                                               int32_t mat_id) {
  int64_t li = static_cast<int64_t>(light_ind) + 1;
  li = li < 0 ? 0 : (li > (1 << 20) - 1 ? (1 << 20) - 1 : li);
  const int32_t m = mat_id < 0 ? 0 : (mat_id > 1023 ? 1023 : mat_id);
  return (static_cast<uint32_t>(is_delta) << 31) |
         (static_cast<uint32_t>(backface) << 30) |
         (static_cast<uint32_t>(li) << 10) | static_cast<uint32_t>(m);
}

struct Flags {
  bool is_delta, backface;
  int32_t light_ind, mat_id;
};

__device__ __forceinline__ Flags unpack_flags(uint32_t w) {
  Flags f;
  f.is_delta = (w >> 31) & 1u;
  f.backface = (w >> 30) & 1u;
  f.light_ind = static_cast<int32_t>((w >> 10) & ((1u << 20) - 1)) - 1;
  f.mat_id = static_cast<int32_t>(w & 1023u);
  return f;
}

__device__ __forceinline__ void store_half3(__half* dst, V3 c) {
  dst[0] = __float2half_rn(c.x);
  dst[1] = __float2half_rn(c.y);
  dst[2] = __float2half_rn(c.z);
}

__device__ __forceinline__ V3 load_half3(const __half* src) {
  return v3(__half2float(src[0]), __half2float(src[1]),
            __half2float(src[2]));
}

// ---- RGB9E5: the mega engines' retirement of a path's radiance ----------
// Replaces utils/packing.py:pack_rgb9e5 (53), pack_rgb9e5_cols (70) and
// unpack_rgb9e5 (83). XLA takes log2(x) as log(x) / 0.6931472f and exp2(x)
// as exp(x * 0.6931472f), so its 2^k is inexact for most |k| > 12; both are
// computed here in double and rounded to float once, as the plain version
// does (utils/packing.py).
constexpr float kLn2F = 0.693147182464599609375f;

__device__ __forceinline__ float exp2_xla(float k) {
  return static_cast<float>(exp(static_cast<double>(k * kLn2F)));
}

__device__ __forceinline__ uint32_t pack_rgb9e5(V3 c) {
  const float r = fminf(fmaxf(c.x, 0.0f), 65408.0f);
  const float g = fminf(fmaxf(c.y, 0.0f), 65408.0f);
  const float b = fminf(fmaxf(c.z, 0.0f), 65408.0f);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float lg =
      static_cast<float>(log(static_cast<double>(fmaxf(maxc, 1e-10f))));
  const float e = fminf(fmaxf(ceilf(lg / kLn2F), -15.0f), 16.0f);
  const float s = exp2_xla(9.0f - e);
  auto mant = [s](float x) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(x * s), 0.0f), 511.0f));
  };
  const uint32_t eb = static_cast<uint32_t>(e + 15.0f);
  return mant(r) | (mant(g) << 9) | (mant(b) << 18) | (eb << 27);
}

__device__ __forceinline__ V3 unpack_rgb9e5(uint32_t u) {
  const float e = static_cast<float>((u >> 27) & 0x1Fu) - 15.0f;
  const float s = exp2_xla(e - 9.0f);
  return v3(static_cast<float>(u & 0x1FFu) * s,
            static_cast<float>((u >> 9) & 0x1FFu) * s,
            static_cast<float>((u >> 18) & 0x1FFu) * s);
}

__device__ __forceinline__ V3 round_rgb9e5(V3 c) {
  return unpack_rgb9e5(pack_rgb9e5(c));
}

}  // namespace tpt
