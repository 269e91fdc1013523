// K12: the BDPT eye and light random walks, on persistent threads with
// per-lane path regeneration.
//
// Replaces cudapathtracer_tpu/models/paths.py:random_walk (line 129),
// start_eye_walk (219) and start_light_walk (237), with models/mis.py:
// advance (41) as mis.cuh. The JAX walk is a lax.scan over depth across the
// whole wavefront. Here a lane holds one path at a time and each loop trip
// steps ONE bounce of it (tpt::walk_bounce, bdpt.cuh): the closest hit (K1,
// or K15 on a threaded scene) -> hit fetch (K2) -> BSDF sample (K3,
// importance transport on the light side) -> the MIS step -> the packed
// vertex store (K10). A lane whose path ends adds that path's counts
// (tpt::finish_walk: rays[i] += and rows[i] +=) and takes the next path id
// from a device counter, whose start it reads (tpt::begin_walk). The
// endpoints (raygen (K7) or the light point, tpt::start_walk) are drawn
// before the walk by a prologue kernel, one thread a path, so no lane
// draws them in the divergent retire branch. It writes the depth-major
// PathBuffers [max_depth-1, N] in the JAX layout, the endpoint (eye: the
// lens point; light: the unpacked vertex 0), the eye walk's escape record
// (the prologue writes a walk's that does not escape, the bounce that
// misses overwrites it), and adds the walk's closest rays to rays[i].
//
// Why: one thread per path ran each warp as long as its longest path
// (events = min(D, valid vertices + 1) a path; the lanes of a warp of 32
// consecutive paths busy 69% / 65% of the time on the light / eye walk of
// the 1080p bunny scene, tools/k5_lanes.py --walk). Under regeneration a
// lane idles only while the others retire or when the ids run out.
//
// Bound: memory latency of the traversal (dependent BVH8 row reads of rays
// that diverge after the first bounce), then the shading-row read per hit.
// Lanes that take ids together take consecutive ids (one warp-aggregated
// atomicAdd), so the endpoints and the first rows they store stay
// contiguous; later rows are written by lanes at different depths.
//
// Every draw is keyed by the pixel id and the depth: a bounce's pairs are
// row `depth` of the walk's key table (keys.cuh walk_key_tables), which a
// small kernel folds from the walk key before the prologue, so a draw is
// one cipher on the pixel id and no lane folds bounce_key(key, depth)
// (each bounce folded it once and each draw once more before). So every
// buffer, the escape record and the counts are the same bits on any grid
// and in any order of the ids.
//
// The rows a walk does not reach hold the dead pattern (store_dead): the
// prologue writes it into every row, coalesced over the paths, and the
// walk then writes only the rows it reaches. (Written by each lane as its
// path retired, inside the divergent retire branch, the dead rows cost
// the walk 1-2% more, PERF.md.)
//
// Table mode: the keyed light walk of the mega engines under TPT_MEGA_LIGHT
// (cudapathtracer_tpu/models/light_mega.py:108 light_walk_mega, with
// utils/rng.py:123,140 draw_key_table and uniform_keyed). The JAX lane
// machine keys a lane's draws by the lane's own depth through a
// per-(bounce, draw) key table folded on the host; here that host table is
// read in place of the one the prologue folds (the same bits), and the
// walk traces BVH8 on every scene. The draws, and so the buffers, the
// escape record and the rays, are bit-equal to the walk's on a BVH8 scene.

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 128;

// Persistent: each thread steps one bounce of its path per loop trip and
// takes the next path when it ends (persistent.cuh). counter: the next
// path id, zero at the launch. lanes (nullable): the lane counters
// (tpt::add_lane_counts), a bounce being an event. At least kMinBlocks
// blocks a SM: ptxas then fits the instantiations in 80 registers (spills
// cached); at 5 (95 registers, no spills) the walks ran ~4% faster than
// at one block a SM (tools/eye_attribution.py --walks), at 6 another 3-5%
// (the hit's material read by id; 8 ties 6, 10 loses;
// tools/shade_attribution.py). The persistent grid is sized from what
// fits.
constexpr int kMinBlocks = 6;
template <int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bdpt_walk_kernel(tpt::WalkLaunch w, unsigned long long* __restrict__ counter,
                 unsigned long long* __restrict__ lanes) {
  int32_t events = 0, calls = 0;
  int64_t i = tpt::next_id(counter);
  if (i < w.n) {
    tpt::WalkState st;
    tpt::begin_walk(w.p, w.out, i, w.px[i], w.py[i], st);
    bool alive = w.out.bufs.depth > 0;
    for (;;) {
      if (alive) {
        if (lanes != nullptr &&
            (threadIdx.x & 31) == __ffs(__activemask()) - 1)
          ++calls;
        alive = tpt::walk_bounce<kEngine>(w.sc, w.p, w.out, i, st);
        ++events;
      }
      if (alive) continue;
      tpt::finish_walk(w.out, i, st);
      i = tpt::next_id(counter);
      if (i >= w.n) break;
      tpt::begin_walk(w.p, w.out, i, w.px[i], w.py[i], st);
      alive = w.out.bufs.depth > 0;
    }
  }
  tpt::add_lane_counts<kThreads>(events, calls, lanes);
}

// The prologue, one thread a path: the path counter to zero, each path's
// endpoint (tpt::start_walk) and the dead pattern into every row of the
// path.
__global__ void __launch_bounds__(kThreads)
bdpt_walk_start_kernel(tpt::WalkLaunch w,
                       unsigned long long* __restrict__ counter) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i == 0) *counter = 0ull;
  if (i >= w.n) return;
  tpt::start_walk(w.sc, w.p, w.out, i, w.px[i], w.py[i]);
  for (int j = 0; j < w.out.bufs.depth; ++j)
    tpt::store_dead(w.out.bufs, j, i);
}

// K12's resident grid for n paths on the engine.
int resident_grid(int engine, int64_t n, unsigned& blocks) {
  return engine == tpt::kEngineThreaded
             ? tpt::resident_grid<bdpt_walk_kernel<tpt::kEngineThreaded>,
                                  kThreads>(n, blocks)
             : tpt::resident_grid<bdpt_walk_kernel<tpt::kEngineBvh8>,
                                  kThreads>(n, blocks);
}

}  // namespace

// ptrs (host array of device addresses, 0 = none): table, tri_f32,
// light_f32, textures, px, py, the 11 buffer fields (pt, n_oct, wo_oct, uv,
// beta, pdf_fwd, d_vcm, d_vc, d_vm, flags, valid), v0_pt, v0_n, v0_beta,
// v0_pdf, v0_light, v0_mat, v0_tri, esc_valid, esc_d, esc_beta, rays, rows,
// key_table (max_depth * 4 + 5 pairs: walk_key_tables), the threaded
// tables (0 under BVH8), the
// path counter (8 bytes of device memory a stream: launches that share it
// must be ordered), lanes (0, or three u64 as the kernel's), start (the light
// walk's [N,4] f32 scratch; 0 for the eye walk), shade_table [T, 16],
// mat_f32 [M, 26].
// iv: n, tri_cols, num_lights, mode (0 eye, 1 light), max_depth, radiance,
// use_vm, engine, bin nodes, bin slots, blocks (0: the resident grid; a test
// argument), build (1: key_table is scratch that a kernel queued first folds
// from the walk key; 0: the host's table, which takes BVH8 only). fv: the 19
// camera floats, plane_area, eta_vcm. keys: 10 draw-key words (eye: the
// camera's 8; light: draws 100..104, which the walk reads from its table) and
// the walk key pair. Returns the launches' cudaError_t.
extern "C" int tpt_bdpt_walk(const int64_t* ptrs, const int64_t* iv,
                             const float* fv, const uint32_t* keys,
                             void* stream) {
  tpt::WalkLaunch w;
  if (!tpt::walk_launch(ptrs, iv, fv, keys, w) || ptrs[31] == 0 ||
      iv[10] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w.n <= 0) return 0;
  auto* counter = tpt::dev_ptr<unsigned long long>(ptrs, 31);
  auto* lanes = tpt::dev_ptr<unsigned long long>(ptrs, 32);
  unsigned grid = static_cast<unsigned>(iv[10]);
  if (grid == 0) {
    const int err = resident_grid(w.engine, w.n, grid);
    if (err != 0) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iv[11] != 0)  // build: fold the table from the walk key
    tpt::launch_key_table(
        tpt::walk_key_tables(w.p.key0, w.p.key1, w.p.max_depth),
        const_cast<tpt::KeyPair*>(w.p.key_table), st);
  bdpt_walk_start_kernel<<<static_cast<unsigned>(
                               (w.n + kThreads - 1) / kThreads),
                           kThreads, 0, st>>>(w, counter);
  if (w.engine == tpt::kEngineThreaded)
    bdpt_walk_kernel<tpt::kEngineThreaded><<<grid, kThreads, 0, st>>>(
        w, counter, lanes);
  else
    bdpt_walk_kernel<tpt::kEngineBvh8><<<grid, kThreads, 0, st>>>(
        w, counter, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the resident grid for n paths on the current device
// (engine: 0 BVH8, 1 threaded). Returns a cudaError_t.
extern "C" int tpt_bdpt_walk_grid(int32_t engine, int64_t n, int32_t* out) {
  unsigned blocks = 0;
  const int err = resident_grid(engine, n, blocks);
  if (err == 0) *out = static_cast<int32_t>(blocks);
  return err;
}
