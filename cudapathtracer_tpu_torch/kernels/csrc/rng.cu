// K6: the id-keyed uniform draw (uniform_id / uniform2_id), and its keyed
// mode (uniform_keyed).
//
// Replaces cudapathtracer_tpu/utils/rng.py:_threefry2x32, uniform_id and
// uniform2_id (lines 80-120), the elementwise Threefry that XLA ran as ~50
// wide uint32 ops per draw, and uniform_keyed (line 140), the same draw with
// a key pair per lane (the pairs gathered from draw_key_table, line 123,
// which the host folds).
//
// Bound: 20 rounds of add/rotate/xor per lane against 4 bytes read and 4-8
// bytes written, so integer ALU throughput bounds it, and at one draw per
// call the launch itself dominates small calls.
// Design: one thread per id; the draw key (k0, k1) is folded on the host
// (a scalar chain of fold_ins) and passed by value, so the kernel reads
// only the ids; the keyed mode reads the lane's pair (8 bytes more). The
// cipher is tpt::threefry2x32 (threefry.cuh), bit-exact
// with JAX's, so every image-parity test of the port can rest on it.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

__global__ void uniform_id_kernel(const int32_t* __restrict__ ids,
                                  float* __restrict__ u0,
                                  float* __restrict__ u1, int64_t n,
                                  uint32_t k0, uint32_t k1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = static_cast<uint32_t>(ids[i]);
  uint32_t x1 = 0u;
  tpt::threefry2x32(k0, k1, x0, x1);
  u0[i] = tpt::bits_to_unit(x0);
  if (u1 != nullptr) u1[i] = tpt::bits_to_unit(x1);
}

__global__ void uniform_keyed_kernel(const int32_t* __restrict__ ids,
                                     const uint32_t* __restrict__ k0,
                                     const uint32_t* __restrict__ k1,
                                     float* __restrict__ u0, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  u0[i] = tpt::uniform_draw_key(k0[i], k1[i], static_cast<uint32_t>(ids[i]));
}

}  // namespace

extern "C" const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u1 may be null (uniform_id); with it, the second word gives uniform2_id's
// second draw. Returns the launch's cudaError_t.
extern "C" int tpt_uniform_id(const int32_t* ids, float* u0, float* u1,
                              int64_t n, uint32_t k0, uint32_t k1,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  uniform_id_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(ids, u0, u1, n,
                                                           k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// The keyed mode: k0, k1 [n] hold each lane's key pair. Returns the
// launch's cudaError_t.
extern "C" int tpt_uniform_keyed(const int32_t* ids, const uint32_t* k0,
                                 const uint32_t* k1, float* u0, int64_t n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  uniform_keyed_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(ids, k0, k1,
                                                              u0, n);
  return static_cast<int>(cudaGetLastError());
}
