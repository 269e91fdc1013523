// Stage 1 of the VCM eye passes: the eye walk (eye.cuh begin_eye_walk,
// eye_walk_bounce, finish_eye_walk) on persistent threads with per-lane
// path regeneration, in the classic VCM / SPPM flavour on the scene's
// engine and in K14's VCM and BDPT flavours on BVH8.
//
// Replaces the walk of the eye pass of cudapathtracer_tpu/models/vcm.py:
// render_sample (line 150) and of models/vcm_mega.py:_mk_eye_machine (322)
// and models/bdpt_mega.py:render_sample (56), with the strategies that
// need no light vertex: s=0 and NEE.
//
// Bound: per bounce one closest ray and one NEE shadow ray (dependent BVH8
// row fetches or threaded node fetches: memory latency), the 64-byte
// shading record and the material row, and a record of 108 bytes written
// (84 of vertex, 24 of terms). Design: at each hit the record (but NEE's
// term) is stored and the walk advanced before NEE, whose BSDF terms are
// evaluated before its shadow ray, so only NEE's own terms and the walk's
// state live across that trace; the connections and the
// merge, with their loops whose length varies from lane to lane, are the
// other two stages, so this kernel carries K12's eye walk plus NEE and
// the records are written depth-major ([D, N]).
//
// Why persistent lanes: a path ends on an escape or a failed BSDF sample,
// with no Russian roulette, so with one thread a path a warp ran as long
// as its longest path (800^2 at eye 16: 7.16 bounces a path on average,
// 12.4% of paths reach all 16; a warp of 32 consecutive paths kept 45% of
// its lanes busy, tools/k5_lanes.py --walk vcm-eye). Here each loop trip
// steps ONE bounce of the path a lane holds (its state in registers,
// tpt::EyeWalk); a lane whose path ended adds the path's counts and takes
// the next path id from a device counter (one warp-aggregated atomic for
// the lanes that ask together, which take consecutive ids), so a lane
// idles only while the others retire or when the ids run out. A start
// kernel zeroes the counter and the flags of every depth (a depth the
// walk does not reach reads 0), coalesced over the paths; the walk then
// writes only the depths it reaches, and a warp's records of one depth
// scatter over the paths its lanes hold.
//
// Every draw is keyed by the pixel (classic: the key table's row of the
// depth on the pixel id) or by the path's list index and depth (mega), never
// by the lane, so the records, the terms and the counts are the same bits
// on any grid and in any order of the ids.
//
// The classic flavour's draws take their pairs from a key table a small
// kernel folds from the eye key first (keys.cuh eye_key_tables: per depth
// the BSDF pairs of bounce_key(key_e, depth) and NEE's of fold_in(bounce
// key, 7)): one cipher a draw.
//
// ptxas (H100 build): 64 registers at the minimum of blocks below, spill
// stores 532 / 352 / 456 / 432 bytes (classic BVH8 / classic threaded /
// K14 VCM / K14 BDPT; one thread a path spilled 460 / 272 / 396 / 392).
// chip_smoke.py prints the report.

#include <cuda_runtime.h>

#include <cstdint>

#include "eye.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 128;

// Persistent: each thread steps one bounce of its path a loop trip and
// takes the next path when it ends (persistent.cuh). c.counter: the next
// path id, zero at the launch; c.lanes (nullable): the lane counters, a
// bounce being an event. At a minimum of kMinBlocks blocks of 128 an SM
// the walk advanced and NEE's terms computed before its shadow ray leave
// the trace few live values, and the warps pay: the walk at 800^2, eye 16
// took 8.60-8.73 ms at 8, 8.71-8.86 at 6 (80 registers), 8.90-8.97 at 5
// (96), and 10.18-10.21 at 8 on half the grid, whose lanes walk twice the
// paths (lane use 0.88 against 0.78: the tail when the ids run out is the
// idle left, and fewer warps hide less latency); the camera ray drawn in
// a path's first loop trip, not in the retire branch, 8.66-8.70 (H100,
// tools/eye_attribution.py --eye-walks). The persistent grid is sized
// from what fits.
constexpr int kMinBlocks = 8;
template <int kFlavor, int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    eye_walk_kernel(tpt::EyeLaunch c) {
  int32_t events = 0, calls = 0;
  int64_t i = tpt::next_id(c.counter);
  if (i < c.n) {
    tpt::EyeWalk w;
    tpt::begin_eye_walk(c, i, w);
    for (;;) {
      if (c.lanes != nullptr &&
          (threadIdx.x & 31) == __ffs(__activemask()) - 1)
        ++calls;
      ++events;
      if (tpt::eye_walk_bounce<kFlavor, kEngine>(c, i, w)) continue;
      tpt::finish_eye_walk(c, i, w);
      i = tpt::next_id(c.counter);
      if (i >= c.n) break;
      tpt::begin_eye_walk(c, i, w);
    }
  }
  tpt::add_lane_counts<kThreads>(events, calls, c.lanes);
}

// The prologue, one thread a path: the path counter to zero and the flags
// of every depth of the path to 0 (not reached).
__global__ void __launch_bounds__(kThreads)
    eye_walk_kernel_start(tpt::EyeLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i == 0) *c.counter = 0ull;
  if (i >= c.n) return;
  for (int t = 0; t < c.p.eye_depth; ++t)
    c.rec.flags[t * c.rec.stride + i] = 0;
}

// The walk's resident grid for c's flavour and engine.
int walk_grid(const tpt::EyeLaunch& c, unsigned& blocks) {
  using namespace tpt;
  if (c.flavor == kEyeMegaVcm)
    return tpt::resident_grid<eye_walk_kernel<kEyeMegaVcm, kEngineBvh8>,
                              kThreads>(c.n, blocks);
  if (c.flavor == kEyeMegaBdpt)
    return tpt::resident_grid<eye_walk_kernel<kEyeMegaBdpt, kEngineBvh8>,
                              kThreads>(c.n, blocks);
  if (c.engine == kEngineThreaded)
    return tpt::resident_grid<eye_walk_kernel<kEyeClassic, kEngineThreaded>,
                              kThreads>(c.n, blocks);
  return tpt::resident_grid<eye_walk_kernel<kEyeClassic, kEngineBvh8>,
                            kThreads>(c.n, blocks);
}

}  // namespace

// The argument layout is eye.cuh's (tpt::eye_launch); the walk needs its
// path counter (ptrs[45]). Returns the launches' cudaError_t.
extern "C" int tpt_eye_walk(const int64_t* ptrs, const int64_t* iv,
                            const float* fv, const uint32_t* keys,
                            void* stream) {
  tpt::EyeLaunch c;
  if (!tpt::eye_launch(ptrs, iv, fv, keys, c) || c.counter == nullptr ||
      iv[24] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  unsigned grid = static_cast<unsigned>(iv[24]);
  if (grid == 0) {
    const int err = walk_grid(c, grid);
    if (err != 0) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace tpt;
  if (c.flavor == kEyeClassic)
    launch_key_table(eye_key_tables(c.p.key_e0, c.p.key_e1, c.p.eye_depth),
                     dev_ptr<KeyPair>(ptrs, 41), st);
  eye_walk_kernel_start<<<static_cast<unsigned>((c.n + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, st>>>(c);
  if (c.flavor == kEyeMegaVcm)
    eye_walk_kernel<kEyeMegaVcm, kEngineBvh8><<<grid, kThreads, 0, st>>>(c);
  else if (c.flavor == kEyeMegaBdpt)
    eye_walk_kernel<kEyeMegaBdpt, kEngineBvh8><<<grid, kThreads, 0, st>>>(c);
  else if (c.engine == kEngineThreaded)
    eye_walk_kernel<kEyeClassic, kEngineThreaded>
        <<<grid, kThreads, 0, st>>>(c);
  else
    eye_walk_kernel<kEyeClassic, kEngineBvh8><<<grid, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
