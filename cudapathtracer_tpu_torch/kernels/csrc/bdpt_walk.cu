// K12: the BDPT eye and light random walks, one thread per path.
//
// Replaces cudapathtracer_tpu/models/paths.py:random_walk (line 129),
// start_eye_walk (219) and start_light_walk (237), with models/mis.py:
// advance (41) as mis.cuh. The JAX walk is a lax.scan over depth across the
// whole wavefront; here one thread runs one path's endpoint and its
// vertices 1..max_depth-1 in program order (tpt::walk_path, bdpt.cuh):
// raygen (K7) or the light endpoint -> closest hit (K1) -> hit fetch (K2)
// -> BSDF sample (K3, importance transport on the light side) -> the MIS
// step -> the packed vertex store (K10) -> continue or die. It writes the
// depth-major PathBuffers [max_depth-1, N] in the JAX layout, the endpoint
// (eye: the lens point; light: the unpacked vertex 0), the eye walk's
// escape record, and adds the walk's closest rays to rays[i].
//
// Bound: memory latency of the traversal (dependent BVH8 row reads of rays
// that diverge after the first bounce), then the shading-row read per hit;
// the stores are ~47 bytes per vertex, coalesced across threads because the
// buffers are depth-major. Design: all walk state in registers; one launch
// per walk direction per sample.
//
// Table mode: the keyed light walk of the mega engines under TPT_MEGA_LIGHT
// (cudapathtracer_tpu/models/light_mega.py:108 light_walk_mega, with
// utils/rng.py:123,140 draw_key_table and uniform_keyed). The JAX lane
// machine keys a lane's draws by the lane's own depth through a
// per-(bounce, draw) key table folded on the host; here one thread walks one
// path, so the same table is read at the walk's depth (ptrs[29]) instead of
// folding bounce_key(key, depth) per thread. The draws, and so the buffers,
// the escape record and the rays, are bit-equal to the folded mode's.

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;

template <int kEngine>
__global__ void __launch_bounds__(kThreads)
bdpt_walk_kernel(tpt::WalkLaunch w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= w.n) return;
  tpt::walk_path<kEngine>(w.sc, w.p, w.out, i, w.px[i], w.py[i]);
}

}  // namespace

// ptrs (host array of device addresses, 0 = none): table, tri_f32,
// light_f32, textures, px, py, the 11 buffer fields (pt, n_oct, wo_oct, uv,
// beta, pdf_fwd, d_vcm, d_vc, d_vm, flags, valid), v0_pt, v0_n, v0_beta,
// v0_pdf, v0_light, v0_mat, v0_tri, esc_valid, esc_d, esc_beta, rays, rows,
// key_table (0: the folded mode), the node table (0 under BVH8).
// iv: n, tri_cols, num_lights, mode (0 eye, 1 light), max_depth, radiance,
// use_vm, engine, node_w, leaf_k (the table mode takes BVH8 only). fv:
// the 19 camera floats, plane_area, eta_vcm. keys: 10 draw-key words (eye:
// the camera's 8; light: draws 100..104) and the walk key pair.
// Returns the launch's cudaError_t.
extern "C" int tpt_bdpt_walk(const int64_t* ptrs, const int64_t* iv,
                             const float* fv, const uint32_t* keys,
                             void* stream) {
  tpt::WalkLaunch w;
  if (!tpt::walk_launch(ptrs, iv, fv, keys, w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((w.n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w.engine == tpt::kEngineThreaded)
    bdpt_walk_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(w);
  else
    bdpt_walk_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(w);
  return static_cast<int>(cudaGetLastError());
}
