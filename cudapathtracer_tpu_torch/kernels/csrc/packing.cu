// K10 (codec part) over a batch: the packed path-vertex codecs of
// packing.cuh, one thread per vector, for the comparison with the plain
// versions (utils/packing.py). On the BDPT path the same device functions
// run inside the walk, splat and connection kernels; this launch is their
// test entry.
//
// Replaces cudapathtracer_tpu/utils/packing.py:23,37,92,98,128,136, and in
// its RGB9E5 mode (tpt_rgb9e5_roundtrip) :53,70,83.
// Bound: memory (about 60 bytes in and out per vector against a few dozen
// flops; RGB9E5 28 bytes against two double transcendentals). Design: the
// encoders and decoders run back to back per thread, so one launch checks
// both directions on the same inputs.

#include <cuda_runtime.h>

#include <cstdint>

#include "packing.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
packing_kernel(const float* __restrict__ vec, const float* __restrict__ beta,
               const bool* __restrict__ is_delta,
               const bool* __restrict__ backface,
               const int32_t* __restrict__ light_ind,
               const int32_t* __restrict__ mat_id, int64_t n,
               uint32_t* __restrict__ oct, float* __restrict__ dec,
               __half* __restrict__ half3, float* __restrict__ beta_dec,
               uint32_t* __restrict__ flags, int32_t* __restrict__ unflags) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const tpt::V3 v = tpt::v3(vec[3 * i], vec[3 * i + 1], vec[3 * i + 2]);
  const uint32_t u = tpt::pack_oct(v);
  oct[i] = u;
  const tpt::V3 w = tpt::unpack_oct(u);
  dec[3 * i] = w.x;
  dec[3 * i + 1] = w.y;
  dec[3 * i + 2] = w.z;
  tpt::store_half3(half3 + 3 * i,
                   tpt::v3(beta[3 * i], beta[3 * i + 1], beta[3 * i + 2]));
  const tpt::V3 b = tpt::load_half3(half3 + 3 * i);
  beta_dec[3 * i] = b.x;
  beta_dec[3 * i + 1] = b.y;
  beta_dec[3 * i + 2] = b.z;
  const uint32_t f =
      tpt::pack_flags(is_delta[i], backface[i], light_ind[i], mat_id[i]);
  flags[i] = f;
  const tpt::Flags g = tpt::unpack_flags(f);
  unflags[4 * i] = g.is_delta;
  unflags[4 * i + 1] = g.backface;
  unflags[4 * i + 2] = g.light_ind;
  unflags[4 * i + 3] = g.mat_id;
}

__global__ void __launch_bounds__(kThreads)
rgb9e5_kernel(const float* __restrict__ c, int64_t n,
              uint32_t* __restrict__ packed, float* __restrict__ dec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t u =
      tpt::pack_rgb9e5(tpt::v3(c[3 * i], c[3 * i + 1], c[3 * i + 2]));
  packed[i] = u;
  const tpt::V3 w = tpt::unpack_rgb9e5(u);
  dec[3 * i] = w.x;
  dec[3 * i + 1] = w.y;
  dec[3 * i + 2] = w.z;
}

}  // namespace

// The RGB9E5 mode: c [n,3] f32 -> packed [n] u32, dec [n,3] f32 (the packed
// word decoded). Returns the launch's cudaError_t.
extern "C" int tpt_rgb9e5_roundtrip(const float* c, int64_t n,
                                    uint32_t* packed, float* dec,
                                    void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  rgb9e5_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, n, packed, dec);
  return static_cast<int>(cudaGetLastError());
}

// vec, beta [n,3] f32; is_delta, backface [n] bool; light_ind, mat_id [n]
// i32 -> oct [n] u32, dec [n,3] f32, half3 [n,3] f16, beta_dec [n,3] f32,
// flags [n] u32, unflags [n,4] i32 (is_delta, backface, light_ind,
// mat_id). Returns the launch's cudaError_t.
extern "C" int tpt_packing_roundtrip(
    const float* vec, const float* beta, const bool* is_delta,
    const bool* backface, const int32_t* light_ind, const int32_t* mat_id,
    int64_t n, uint32_t* oct, float* dec, void* half3, float* beta_dec,
    uint32_t* flags, int32_t* unflags, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  packing_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vec, beta, is_delta, backface, light_ind, mat_id, n, oct, dec,
      static_cast<__half*>(half3), beta_dec, flags, unflags);
  return static_cast<int>(cudaGetLastError());
}
