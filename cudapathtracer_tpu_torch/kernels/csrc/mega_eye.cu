// K14: the mega engines' eye pass (VCM, SPPM and BDPT with their default
// engine), one thread per pixel of a chunk.
//
// Replaces cudapathtracer_tpu/models/vcm_mega.py:_mk_eye_machine (line 322)
// and _pack_conn_table (148), and the eye machine of
// models/bdpt_mega.py:render_sample (56): the per-pixel body is
// tpt::mega_eye_pixel (mega.cuh), which runs inside it K9's slot
// enumeration (hashgrid.cuh) and K10's RGB9E5 retirement (packing.cuh).
//
// Bound: per bounce one closest ray, one NEE shadow ray and up to
// light_rows connection shadow rays (BVH8 traversals bound by memory
// latency), then under VCM up to 64 photon rows (32 bytes each, scattered)
// with three BSDF evaluations per photon in range. Design: the walk state
// and the running radiance in registers, the light vertices read from K12's
// depth-major buffers, the grid through the L1/L2 caches; no shared
// memory. ptxas' registers, stack frame and spills are printed by
// chip_smoke.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "mega.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) mega_eye_kernel(tpt::MegaLaunch c) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (l >= c.n) return;
  tpt::mega_eye_one(c, l);
}

}  // namespace

// ptrs: table, tri_f32, light_f32, mat_f32, textures, px, py (the chunk's
// c_pix pixels), the 11 light-buffer fields [light_rows, c_pix], grid rows,
// cell_se (0, 0 without the merge), out [P,3], rays, dropped, rows (0 =
// none) [c_pix]. iv: n (live pixels), c_pix, tri_cols, num_lights,
// eye_depth, light_rows, flavor (0 vcm, 1 bdpt), naive, nee, connection,
// do_mis, paint_weight, sample_environment, merge, sppm, table_size,
// max_per_cell, one_brick, reweight, grid rows P8, gbase. fv: the 19
// camera floats, plane_area, eta_vcm, merge_norm, scene_min[3], cell_size,
// merge radius squared. keys: the 8 camera draw-key words, the BSDF draw
// keys 0-3 and NEE's 16-18 of the eye key (22 words). Returns the launch's
// cudaError_t.
extern "C" int tpt_mega_eye(const int64_t* ptrs, const int64_t* iv,
                            const float* fv, const uint32_t* keys,
                            void* stream) {
  tpt::MegaLaunch c;
  if (!tpt::mega_launch(ptrs, iv, fv, keys, c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  mega_eye_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c);
  return static_cast<int>(cudaGetLastError());
}
