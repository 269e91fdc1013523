// K15: the threaded binary-BVH engine's closest-hit and any-hit shadow
// traversal, one launch per batch of rays.
//
// Replaces cudapathtracer_tpu/ops/traverse.py:closest_hit (line 132) and
// shadow_factor (line 203) on a traversal="threaded" scene. The per-ray
// walk lives in traverse_bin.cuh (tpt::trace_bin), which the per-path and
// BDPT/VCM kernels instantiate for a threaded scene; this file maps one
// thread to one ray of the batch and writes its result. What bounds the
// walk and how its design answers that is in traverse_bin.cuh.

#include <cuda_runtime.h>

#include <cstdint>

#include "traverse_bin.cuh"

namespace {

// The batch entries' block: 64 threads timed faster than 128 and 256 in
// both entries (tools/k8_k15_attribution.py).
constexpr int kThreads = 64;

template <bool kShadow>
__global__ void __launch_bounds__(kThreads)
traverse_bin_kernel(const float* __restrict__ bin, int32_t nodes,
                    const float* __restrict__ tri_f32, int tri_cols,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ max_t,
                    const int32_t* __restrict__ skip,
                    const bool* __restrict__ active, int64_t n,
                    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    float* __restrict__ scale_out,
                    int32_t* __restrict__ rows_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const tpt::Trace8 r = tpt::trace_bin<kShadow>(
      bin, nodes, tri_f32, tri_cols, o[3 * i], o[3 * i + 1],
      o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2], max_t[i], skip[i],
      active == nullptr || active[i]);
  if (rows_out != nullptr) rows_out[i] = r.rows;
  if (kShadow) {
    scale_out[3 * i] = r.s0;
    scale_out[3 * i + 1] = r.s1;
    scale_out[3 * i + 2] = r.s2;
  } else {
    t_out[i] = r.t;
    tri_out[i] = r.tri;
    u_out[i] = r.u;
    v_out[i] = r.v;
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// bin: the threaded tables (traverse_bin.cuh) of `nodes` node records and
// `slots` leaf triangles. active may be null (every ray traced),
// and so may rows (per ray, the number of node rows visited). Returns the
// launch's cudaError_t.
extern "C" int tpt_closest_hit_bin(const float* bin, int32_t nodes,
                                   int32_t slots, const float* o,
                                   const float* d, const float* max_t,
                                   const int32_t* skip_tri,
                                   const bool* active, int64_t n, float* t,
                                   int32_t* tri, float* u, float* v,
                                   int32_t* rows, void* stream) {
  if (!tpt::engine_ok(tpt::kEngineThreaded, bin, nodes, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  traverse_bin_kernel<false><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      bin, nodes, nullptr, 0, o, d, max_t, skip_tri, active, n, t,
      tri, u, v, nullptr, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpt_shadow_factor_bin(const float* bin, int32_t nodes,
                                     int32_t slots, const float* tri_f32,
                                     int32_t tri_cols, const float* o,
                                     const float* d, const float* max_t,
                                     const int32_t* skip_tri,
                                     const bool* active, int64_t n,
                                     float* scale, int32_t* rows,
                                     void* stream) {
  if (!tpt::engine_ok(tpt::kEngineThreaded, bin, nodes, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  traverse_bin_kernel<true><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      bin, nodes, tri_f32, tri_cols, o, d, max_t, skip_tri, active,
      n, nullptr, nullptr, nullptr, nullptr, scale, rows);
  return static_cast<int>(cudaGetLastError());
}
