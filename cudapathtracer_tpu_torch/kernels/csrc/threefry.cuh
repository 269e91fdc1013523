// Threefry-2x32 (20 rounds), the cipher behind jax.random's threefry PRNG,
// as a host/device helper shared by the port's kernels: rng.cu (K6) draws
// with it, camera.cu (K7) calls it per pixel, and later per-path kernels
// call it for their own draws. Bit-identical to
// cudapathtracer_tpu/utils/rng.py:_threefry2x32 and _bits_to_unit.
#pragma once

#include <cstdint>

namespace tpt {

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Encrypts the block (x0, x1) in place under the key (k0, k1).
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// 23 mantissa bits -> [0, 1); exact in float32.
__host__ __device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 9) * 1.1920928955078125e-07f;
}

// uniform_id for one lane: the draw keyed by `id` under draw key (k0, k1).
__host__ __device__ __forceinline__ float uniform_draw_key(uint32_t k0,
                                                           uint32_t k1,
                                                           uint32_t id) {
  uint32_t x0 = id, x1 = 0u;
  threefry2x32(k0, k1, x0, x1);
  return bits_to_unit(x0);
}

}  // namespace tpt
