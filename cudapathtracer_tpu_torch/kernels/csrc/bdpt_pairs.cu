// K13, stage 1 of 2: the BDPT connection shadow rays, one thread per
// (eye depth t, slot, pixel i) (tpt::pair_term, bdpt.cuh). Slot 0 is s = 1
// (NEE), slot 1 + j the connection to stored light vertex j; the thread's
// weighted contribution, or +0, goes to terms [D, S, N, 3] (D =
// eye_depth - 1, S = light_depth), which bdpt_gather.cu sums per pixel.
//
// Replaces cudapathtracer_tpu/models/bdpt.py:_bdpt_nee (line 175) and the
// s >= 1 strategies of render_sample's connection stage (226, lines
// 258-441).
//
// Bound: one shadow ray per traced pair (up to 7 x 6 a pixel at eye depth
// 8 and light depth 6), each a traversal bound by memory latency
// (dependent BVH8 row or node fetches); the eye vertex (51 bytes) and the
// light vertex (51 bytes) read, 12 bytes written per pair. Design: on
// BVH8, one shadow ray a thread, no loop whose length varies from lane to
// lane, so a warp no longer waits for its pixel with the longest eye path;
// blockIdx.y is the pair (t, slot) and a warp holds 32 neighbouring pixels
// of it, so K12's depth-major [D, N] buffers and terms are read and
// written coalesced, and a thread whose eye vertex is invalid or delta
// writes +0 and leaves before it fetches a light vertex. s=1's light point
// takes its three pairs from row t of a key table that a small kernel
// folds from key_c first (keys.cuh nee_key_tables): one cipher a draw, not
// a fold of fold_in(key_c, t) and a fold a draw besides (seven ciphers a
// NEE pair before). On the threaded
// engine a thread takes all of its pixel's pairs in (t, slot) order (the
// launch's `per`): K15's node walks vary much more from ray to ray than
// K1's row walks, and a thread's sum over ~40 rays evens that out (1080p,
// H100: one pair a thread 58.8 ms on BVH8 and 82.3 threaded, all of a
// pixel's 84.9 and 70.5; tools/eye_attribution.py --per). The rays and
// rows are integer atomics, so their totals stay exact in any order.
// ptxas (H100 build), at a minimum of kMinBlocks blocks of 128 threads an
// SM: 64 registers, spills cached. The shading code's fewer live values
// (the material read by id, the fused evaluations) make the warps pay: a
// 1080p sample 45.6 ms at 8, 45.2 at 10, 48.9 at 6, 50.8 at 5, 57.1 at 4
// (128 registers; H100, tools/shade_attribution.py). A minimum of 3 blocks (143
// registers) took 67.3 ms against 58.8 at 4 before (tools/eye_attribution
// --per 1).

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;

// Thread (blockIdx.y, i) takes `per` consecutive pairs (t, slot) of pixel
// i, from pair blockIdx.y * per in (t, slot) order.
template <int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bdpt_pairs_kernel(tpt::ConnectLaunch c, int per) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  const int first = static_cast<int>(blockIdx.y) * per;
  for (int ts = first; ts < first + per; ++ts) {
    const int t = 2 + ts / c.p.light_depth, slot = ts % c.p.light_depth;
    tpt::put3(c.terms, tpt::term_row(c, t, slot, i),
              tpt::pair_term<kEngine>(c, t, slot, i));
  }
}

}  // namespace

// ptrs: table, tri_f32, light_f32, mat_f32, textures, px, py, the 11
// eye-buffer fields, ev0_pt, esc_valid, esc_d, esc_beta, the 11
// light-buffer fields, fb, out, rays, rows (0 = none), the threaded
// tables (0 under BVH8), terms, shade_table [T, 16], the NEE key table
// ((eye_depth + 1) x 3 pairs of scratch, written here). iv: n, tri_cols,
// num_lights, eye_depth,
// light_depth, naive, nee, connection, do_mis, paint_weight,
// sample_environment, engine, bin nodes, bin slots, per (the pairs a
// thread takes, a divisor of the (eye_depth - 1) x light_depth pairs of a
// pixel). fv: the 19 camera
// floats, plane_area. keys: key_c. The pairs read the eye and light
// buffers, px, py and write terms, rays and rows; ev0_pt, the escape, fb
// and out may be 0. Returns the launch's cudaError_t.
extern "C" int tpt_bdpt_pairs(const int64_t* ptrs, const int64_t* iv,
                              const float* fv, const uint32_t* keys,
                              void* stream) {
  tpt::ConnectLaunch c;
  const int per = static_cast<int>(iv[14]);
  if (!tpt::connect_launch(ptrs, iv, fv, keys, c) || c.px == nullptr ||
      c.py == nullptr || c.rays == nullptr || c.p.nee_keys == nullptr ||
      per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pairs =
      static_cast<int64_t>(c.p.eye_depth - 1) * c.p.light_depth;
  if (pairs % per != 0 || pairs / per > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const dim3 blocks(static_cast<unsigned>((c.n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(pairs / per));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tpt::launch_key_table(
      tpt::nee_key_tables(c.p.key_c0, c.p.key_c1, c.p.eye_depth),
      tpt::dev_ptr<tpt::KeyPair>(ptrs, 40), st);
  if (c.engine == tpt::kEngineThreaded)
    bdpt_pairs_kernel<tpt::kEngineThreaded>
        <<<blocks, kThreads, 0, st>>>(c, per);
  else
    bdpt_pairs_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(c, per);
  return static_cast<int>(cudaGetLastError());
}
