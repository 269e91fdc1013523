// Threefry-2x32 (20 rounds), the cipher behind jax.random's threefry PRNG,
// as a host/device helper shared by the port's kernels: rng.cu (K6) draws
// with it, camera.cu (K7) calls it per pixel, the hosts draw with
// uniform_draw_key, and the key-table prologues (keys.cuh) fold their keys
// with it. Bit-identical to cudapathtracer_tpu/utils/rng.py:_threefry2x32
// and _bits_to_unit.
//
// On the card a round is one IADD3 (x0 += x1), one SHF.L.W (the rotation,
// a funnel shift of x1 with itself) and one LOP3 (x1 ^= x0), and each key
// injection one IADD3 per word (the round constant folds into it):
// tools/rng_attribution.py --sass counts the instructions of the built
// cipher.
#pragma once

#include <cstdint>

namespace tpt {

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

constexpr uint32_t kThreefryParity = 0x1BD11BDAu;

// Encrypts the block (x0, x1) in place under the key schedule (k0, k1,
// k2 = k0 ^ k1 ^ kThreefryParity).
__host__ __device__ __forceinline__ void threefry2x32_ks(uint32_t k0,
                                                         uint32_t k1,
                                                         uint32_t k2,
                                                         uint32_t& x0,
                                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k2};
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

// Encrypts the block (x0, x1) in place under the key (k0, k1).
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  threefry2x32_ks(k0, k1, k0 ^ k1 ^ kThreefryParity, x0, x1);
}

// fold_in(key, data) = threefry2x32(key, (0, data)): the next key of a
// chain (sample, bounce, draw).
__host__ __device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1,
                                                 uint32_t data, uint32_t& o0,
                                                 uint32_t& o1) {
  o0 = 0u;
  o1 = data;
  threefry2x32(k0, k1, o0, o1);
}

// 23 mantissa bits -> [0, 1); exact in float32.
__host__ __device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 9) * 1.1920928955078125e-07f;
}

// uniform_id for one lane: the draw keyed by `id` under draw key (k0, k1),
// one cipher.
__host__ __device__ __forceinline__ float uniform_draw_key(uint32_t k0,
                                                           uint32_t k1,
                                                           uint32_t id) {
  uint32_t x0 = id, x1 = 0u;
  threefry2x32(k0, k1, x0, x1);
  return bits_to_unit(x0);
}

// uniform2_id for one lane: both words of the same cipher.
__host__ __device__ __forceinline__ void uniform2_draw_key(uint32_t k0,
                                                           uint32_t k1,
                                                           uint32_t id,
                                                           float& u0,
                                                           float& u1) {
  uint32_t x0 = id, x1 = 0u;
  threefry2x32(k0, k1, x0, x1);
  u0 = bits_to_unit(x0);
  u1 = bits_to_unit(x1);
}

// The draws of one row of a key table (keys.cuh) or of a host-folded key
// list: draw d is keyed by the pair keys[2d], keys[2d + 1] and the lane's
// id, one cipher a draw.
struct TableDraws {
  const uint32_t* keys;
  uint32_t id;
  __device__ __forceinline__ float operator()(int d) const {
    return uniform_draw_key(keys[2 * d], keys[2 * d + 1], id);
  }
};

}  // namespace tpt
