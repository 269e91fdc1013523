// K11: the t=1 light-trace splat, one thread per light vertex, in its BDPT
// and VCM forms.
//
// bdpt_splat replaces cudapathtracer_tpu/models/bdpt.py:light_trace_splat
// (line 93); its VCM mode (iv vcm) replaces models/vcm.py:vcm_light_splat
// (line 87), which splats only the stored vertices (not the endpoint) and
// adds eta_vcm to each vertex's w_light (SplatParams::vcm).
// Every light vertex (the unpacked endpoint s=1 and the stored vertices
// s>=2, decoded through K10) is projected onto the image
// (tpt::world_to_raster), tested for visibility with a shadow ray to the
// lens (K1), weighted by We G f and its MIS weight (tpt::splat_vertex,
// bdpt.cuh), and added into the frame buffer with atomicAdd where XLA
// scatter-adds. The raster index is truncated, then clipped, as there.
// Float atomics make each pixel's sum order-nondeterministic.
//
// Bound: the shadow ray's BVH8 traversal (memory latency), then the
// scattered atomics into the frame buffer. Design: thread k handles vertex
// k / N of light path k % N, so a warp reads one depth row of the
// depth-major buffers contiguously; vertices that are invalid, delta or off
// screen return before their shadow ray.

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;

template <int kEngine>
__global__ void __launch_bounds__(kThreads)
bdpt_splat_kernel(tpt::SplatLaunch s) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int first = s.p.vcm ? 1 : 0;  // VCM splats no endpoint
  if (k >= s.n * (s.lb.depth + 1 - first)) return;
  const int j = static_cast<int>(k / s.n) + first;
  const int64_t i = k % s.n;
  if (i >= s.n_live) return;
  tpt::splat_vertex<kEngine>(s.sc, s.p, s.lb, s.e, j, i, s.fb, s.rays,
                             s.rows);
}

}  // namespace

// ptrs: table, tri_f32, mat_f32, textures, the 11 light-buffer fields,
// v0_pt, v0_n, v0_beta, v0_pdf, v0_mat (0 in VCM's form), fb, rays, rows
// (0 = none), the node table (0 under BVH8). iv: n, tri_cols, depth
// (stored light vertices), width, height, do_mis, paint_weight, vcm,
// n_live (paths i >= n_live are skipped: the mega engines' chunk pads),
// engine, node_w, leaf_k. fv: the 19 camera floats, plane_area,
// eta_vcm. Returns the launch's cudaError_t.
extern "C" int tpt_bdpt_splat(const int64_t* ptrs, const int64_t* iv,
                              const float* fv, void* stream) {
  tpt::SplatLaunch s;
  if (!tpt::splat_launch(ptrs, iv, fv, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = s.n * (s.lb.depth + (s.p.vcm ? 0 : 1));
  if (threads <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.engine == tpt::kEngineThreaded)
    bdpt_splat_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(s);
  else
    bdpt_splat_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}
