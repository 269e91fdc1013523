// K6: the id-keyed uniform draw (uniform_id / uniform2_id), its keyed mode
// (uniform_keyed), and the test entry of the hosts' key tables (keys.cuh).
//
// Replaces cudapathtracer_tpu/utils/rng.py:_threefry2x32, uniform_id and
// uniform2_id (lines 80-120), the elementwise Threefry that XLA ran as ~50
// wide uint32 ops per draw, and uniform_keyed (line 140), the same draw with
// a key pair per lane (the pairs gathered from draw_key_table, line 123,
// which the host folds).
//
// Bound: one cipher a lane, about 80 SASS integer instructions (20 rounds
// of IADD3, SHF.L.W and LOP3, the key injections' IADD3s) on the INT32
// pipe, which issues 64 lanes a clock an SM (half the FP32 rate), against
// 8 bytes moved a lane (12 more in the keyed mode): at 2M ids the integer
// work bounds the plain draw and the bytes the keyed one, each about
// 0.01 ms on an H100, and the launch and its tail are a large part of so
// short a call.
// Design: one thread per id; the draw key (k0, k1) is folded on the host
// (a scalar chain of fold_ins) and passed by value, so the kernel reads
// only the ids; the keyed mode reads the lane's pair (8 bytes more). The
// cipher is tpt::threefry2x32 (threefry.cuh), bit-exact with JAX's, so
// every image-parity test of the port can rest on it. Inside the hosts the
// same cipher runs once a draw under a pair from a key table
// (keys.cuh); tpt_key_table runs the prologue that folds those tables, for
// chip_smoke.py to hold each to its plain builder.

#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"
#include "threefry.cuh"

namespace {

__global__ void uniform_id_kernel(const int32_t* __restrict__ ids,
                                  float* __restrict__ u0,
                                  float* __restrict__ u1, int64_t n,
                                  uint32_t k0, uint32_t k1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  float a, b;
  tpt::uniform2_draw_key(k0, k1, static_cast<uint32_t>(ids[i]), a, b);
  u0[i] = a;
  if (u1 != nullptr) u1[i] = b;
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

// Test entry: the key table a host's prologue folds, written to out
// (sizeof(KeyPair) bytes a pair, device memory). kind: 0 K5's draw-key
// table (dims[1] samples from dims[0] under the base key, dims[2] rows:
// uni_mega.cu key_rows, 0 for the mega schedule's one row), 1 K12's walk
// table
// (max_depth dims[0]), 2 the classic eye walk's (eye_depth dims[0]), 3
// K13's s=1 table (eye_depth dims[0]); key: the launch word pair. Returns
// the table's pairs, or -1 for an unknown kind; launches only when out is
// not null (then a negative cudaError_t on a failed launch).
extern "C" int64_t tpt_key_table(int32_t kind, uint32_t k0, uint32_t k1,
                                 const int64_t* dims, void* out,
                                 void* stream) {
  tpt::KeyTables kt;
  switch (kind) {
    case 0:
      kt = tpt::uni_key_tables(k0, k1, static_cast<uint32_t>(dims[0]),
                               static_cast<int32_t>(dims[1]),
                               static_cast<int32_t>(dims[2]));
      break;
    case 1:
      kt = tpt::walk_key_tables(k0, k1, static_cast<int32_t>(dims[0]));
      break;
    case 2:
      kt = tpt::eye_key_tables(k0, k1, static_cast<int32_t>(dims[0]));
      break;
    case 3:
      kt = tpt::nee_key_tables(k0, k1, static_cast<int32_t>(dims[0]));
      break;
    default:
      return -1;
  }
  if (out != nullptr) {
    tpt::launch_key_table(kt, static_cast<tpt::KeyPair*>(out),
                          static_cast<cudaStream_t>(stream));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return -err;
  }
  return tpt::key_table_entries(kt);
}
