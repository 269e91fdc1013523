// K13's VCM form with the K9 merge: the VCM / SPPM eye pass, one thread per
// pixel.
//
// Replaces the eye pass of cudapathtracer_tpu/models/vcm.py:render_sample
// (line 150) and, inside it, ops/hashgrid.py:fold_neighbors (240): the
// on-the-fly eye walk with s=0, NEE, connections to every stored light
// vertex and the photon merge per bounce (tpt::vcm_eye_pixel, vcm.cuh),
// then the splat's frame buffer is added.
//
// Bound: per bounce one closest ray, one NEE shadow ray and up to
// light_depth connection shadow rays (traversals on the scene's engine,
// bound by memory latency), then up to 8 x cap photon rows (32 bytes each,
// scattered) with three BSDF evaluations per photon in range. Design: the
// walk state and the running radiance in registers; the merge reads the
// (start, end) table and the rows through the L1/L2 caches; no shared
// memory. ptxas' registers, stack frame and spills are printed by
// chip_smoke.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "vcm.cuh"

namespace {

constexpr int kThreads = 128;

template <int kEngine>
__global__ void __launch_bounds__(kThreads) vcm_eye_kernel(tpt::VcmLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  tpt::vcm_eye_one<kEngine>(c, i);
}

}  // namespace

// ptrs: table, tri_f32, light_f32, mat_f32, textures, px, py, the 11
// light-buffer fields, grid rows, cell_se (0, 0 without the merge), fb (0 =
// none), out, rays, dropped, rows (0 = none), the node table (0 under
// BVH8). iv: n, tri_cols, num_lights, eye_depth, light_depth, naive, nee,
// connection, do_mis, paint_weight, sample_environment, merge, sppm,
// table_size, max_per_cell, one_brick, reweight, engine, node_w, leaf_k.
// fv: the 19 camera floats, plane_area, eta_vcm, merge_norm,
// scene_min[3], cell_size, merge radius squared. keys: the 8 camera draw-key
// words, 2 unused, the eye key pair. Returns the launch's cudaError_t.
extern "C" int tpt_vcm_eye(const int64_t* ptrs, const int64_t* iv,
                           const float* fv, const uint32_t* keys,
                           void* stream) {
  tpt::VcmLaunch c;
  if (!tpt::vcm_launch(ptrs, iv, fv, keys, c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c.engine == tpt::kEngineThreaded)
    vcm_eye_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(c);
  else
    vcm_eye_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
