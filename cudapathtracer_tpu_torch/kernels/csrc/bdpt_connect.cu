// K13: the BDPT connection stage, one thread per pixel.
//
// Replaces cudapathtracer_tpu/models/bdpt.py:_bdpt_nee (line 175) and the
// connection stage of render_sample (226, lines 258-441): the environment
// term of an escaped eye walk, then for t = 2..eye_depth the s=0 strategy
// (the eye walk hit a light; the firefly clamp past t=2), s=1 (NEE with
// keys fold_in(key_c, t), the G clamp 15, a shadow ray that skips the
// light's triangle) and s>=2 (every stored light vertex: four reverse pdfs,
// the G clamp 2, a shadow ray), summed in the JAX order; finally the
// splat's frame buffer is added (li + fb). tpt::connect_pixel, bdpt.cuh.
//
// Bound: up to (eye_depth - 1) x light_depth shadow rays per pixel (35 at
// eye depth 8 and light depth 6), each a BVH8 traversal bound by memory
// latency; the BSDF and MIS arithmetic is a few hundred flops per
// connection. Design: the thread keeps the running radiance in registers
// and re-reads the decoded light vertices for each t (they stay in L1/L2);
// the shadow traversal's 16-entry stack lives in local memory (ptxas'
// stack frame and spills are printed by chip_smoke.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;

template <int kEngine>
__global__ void __launch_bounds__(kThreads)
bdpt_connect_kernel(tpt::ConnectLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  tpt::connect_one<kEngine>(c, i);
}

}  // namespace

// ptrs: table, tri_f32, light_f32, mat_f32, textures, px, py, the 11
// eye-buffer fields, ev0_pt, esc_valid, esc_d, esc_beta, the 11
// light-buffer fields, fb, out, rays, rows (0 = none), the node table (0
// under BVH8). iv: n, tri_cols, num_lights, eye_depth, light_depth, naive,
// nee, connection, do_mis, paint_weight, sample_environment, engine,
// node_w, leaf_k. fv: the 19 camera floats, plane_area.
// keys: key_c. Returns the launch's cudaError_t.
extern "C" int tpt_bdpt_connect(const int64_t* ptrs, const int64_t* iv,
                                const float* fv, const uint32_t* keys,
                                void* stream) {
  tpt::ConnectLaunch c;
  if (!tpt::connect_launch(ptrs, iv, fv, keys, c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c.engine == tpt::kEngineThreaded)
    bdpt_connect_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(c);
  else
    bdpt_connect_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
