// Stage 2 of the VCM eye passes: the connections (s >= 2) of every (eye
// depth t, light row j, path i) pair (tpt::eye_connect_one, eye.cuh), in
// the classic VCM flavour on the scene's engine and in K14's VCM and BDPT
// flavours on BVH8. SPPM and any pass with the connections off do not
// launch it.
//
// Replaces the connections of cudapathtracer_tpu/models/vcm.py:
// render_sample's eye pass (line 150) and of models/vcm_mega.py:
// _mk_eye_machine (322) with _pack_conn_table (148), and of
// models/bdpt_mega.py:render_sample (56).
//
// Bound: one shadow ray per traced pair (dependent BVH8 row fetches:
// memory latency), the eye record (84 bytes) and the light vertex (51
// bytes, K12's packed buffers) read, 12 bytes written per pair.
//
// Why a queue: one thread a (t, j, i) slot gives a warp 32 neighbouring
// paths of one pair (t, j); light path lengths and eye path ends vary from
// lane to lane, so nearly every warp traces, each with a few of its lanes
// (800^2 at eye 16, light 10: 15.8% lane use, 5 of 32). The entry runs
// two kernels instead, after zeroing the queue's length:
//
//   1. eye_connect_kernel_queue, one thread a path i, a warp 32
//      neighbouring paths: the lane's light vertices that pass conn_light
//      as the bits of one word, its live records counted; the warp's pairs
//      summed, one atomicAdd a warp reserving their slots of the queue,
//      then each written at its rank, in (t, j) order, as slot (t L + j)
//      n + i. At each (t, j) where one of the warp's records is live the
//      pass zeroes all 32 rows of conn, the queued ones included: whole
//      rows, so whole sectors, are written (a row the trace later fills
//      is written twice; zeroing only the unqueued rows left partial
//      sectors and took 0.91 ms a dispatch at 800^2 against 0.69).
//   2. eye_connect_kernel_trace, a persistent grid (the blocks that fit on
//      the card at once) walking the queue with a grid-stride loop up to
//      the length the card holds: no host sync and no grid sized by the
//      D L n slots. Each entry runs eye_connect_one, so a warp traces up
//      to 32 queued pairs of nearby paths; the pairs whose cosines fail
//      (about 1 in 7) leave their lanes idle.
//
// Each slot's result is the same whatever the queue's order: its rays and
// rows are integer atomics, its contribution its own row of conn.

#include <cuda_runtime.h>

#include <cstdint>

#include "eye.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 128;
// The trace kernel at a minimum of kMinBlocks blocks of 128 an SM (64
// registers, spills cached): the connection's lobes read by id and
// evaluated once a side leave few live values, and the warps pay (the
// stage at 800^2, eye 16, light 10: 14.22 ms a dispatch at 8, 14.30 at
// 10, 14.83 at 6; H100 80GB HBM3).
constexpr int kMinBlocks = 8;
constexpr int kQueueThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxLightRows = 64;   // a lane's light rows in one word

// One thread a path i; whole warps stay to the ballots. tally[3] += the
// pairs queued and, once a launch, tally[4] += the D L n slots.
__global__ void __launch_bounds__(kQueueThreads)
    eye_connect_kernel_queue(tpt::EyeLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool in = i < c.n;
  const int depth = c.p.eye_depth, lrows = c.p.light_rows;
  const int64_t n = c.n;
  const unsigned lane = threadIdx.x & 31u;
  uint64_t open = 0;
  int reach = 0, lives = 0;  // the depths past the lane's last record are 0
  if (in) {
#pragma unroll 4
    for (int j = 0; j < lrows; ++j)
      open |= static_cast<uint64_t>(tpt::conn_light(c, j, i)) << j;
#pragma unroll 4
    for (int t = 0; t < depth; ++t) {
      const int32_t f = c.rec.flags[t * n + i];
      if (f != 0) reach = t + 1;
      lives += (f & tpt::kRecConn) == tpt::kRecConn;
    }
  }
  const uint32_t count = __reduce_add_sync(
      kAll, static_cast<uint32_t>(lives * __popcll(open)));
  reach = static_cast<int>(
      __reduce_max_sync(kAll, static_cast<uint32_t>(reach)));
  uint32_t at = 0;
  if (lane == 0 && count != 0) {
    at = atomicAdd(c.queued, count);
    if (c.tally != nullptr)
      atomicAdd(c.tally + 3, static_cast<unsigned long long>(count));
  }
  if (c.tally != nullptr && i == 0)
    atomicAdd(c.tally + 4, static_cast<unsigned long long>(depth) * lrows *
                               static_cast<unsigned long long>(n));
  at = __shfl_sync(kAll, at, 0);
  const unsigned below = (1u << lane) - 1u;
  const tpt::V3 zero = tpt::v3(0.0f, 0.0f, 0.0f);
  for (int t = 0; t < reach; ++t) {
    const bool live =
        in && (c.rec.flags[t * n + i] & tpt::kRecConn) == tpt::kRecConn;
    if (!__any_sync(kAll, live)) continue;
    for (int j = 0; j < lrows; ++j) {
      const bool ok = live && ((open >> j) & 1u);
      const unsigned b = __ballot_sync(kAll, ok);
      const int64_t slot = (static_cast<int64_t>(t) * lrows + j) * n + i;
      if (ok) c.queue[at + __popc(b & below)] = static_cast<uint32_t>(slot);
      if (in) tpt::put3(c.conn, slot, zero);
      at += __popc(b);
    }
  }
}

template <int kFlavor, int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    eye_connect_kernel_trace(tpt::EyeLaunch c) {
  const int64_t len = *c.queued;
  const uint32_t n = static_cast<uint32_t>(c.n);
  const uint32_t lrows = static_cast<uint32_t>(c.p.light_rows);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < len; q += stride) {
    const uint32_t s = c.queue[q];
    const uint32_t tj = s / n;
    tpt::eye_connect_one<kFlavor, kEngine>(
        c, static_cast<int>(tj / lrows), static_cast<int>(tj % lrows),
        static_cast<int64_t>(s - tj * n));
  }
}

template <int kFlavor, int kEngine>
int launch_trace(const tpt::EyeLaunch& c, int64_t slots, cudaStream_t st) {
  constexpr auto kernel = eye_connect_kernel_trace<kFlavor, kEngine>;
  unsigned blocks = 0;
  const int err = tpt::resident_grid<kernel, kThreads>(slots, blocks);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, 0, st>>>(c);
  return 0;
}

}  // namespace

// The argument layout is eye.cuh's (tpt::eye_launch); conn (ptrs[39]), the
// queue (ptrs[43]: eye_depth x light_rows x n words) and its length
// (ptrs[44]: one word, zeroed here) are required, light_rows <= 64 and
// eye_depth x light_rows x n < 2^32. Returns the launches' cudaError_t.
extern "C" int tpt_eye_connect(const int64_t* ptrs, const int64_t* iv,
                               const float* fv, const uint32_t* keys,
                               void* stream) {
  tpt::EyeLaunch c;
  if (!tpt::eye_launch(ptrs, iv, fv, keys, c) || c.conn == nullptr ||
      c.queue == nullptr || c.queued == nullptr || c.p.light_rows < 1 ||
      c.p.light_rows > kMaxLightRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slots =
      static_cast<int64_t>(c.p.eye_depth) * c.p.light_rows * c.n;
  if (slots >= (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(c.queued, 0, sizeof(uint32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  eye_connect_kernel_queue<<<static_cast<unsigned>(
                                 (c.n + kQueueThreads - 1) / kQueueThreads),
                             kQueueThreads, 0, st>>>(c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  using namespace tpt;
  int err;
  if (c.flavor == kEyeMegaVcm)
    err = launch_trace<kEyeMegaVcm, kEngineBvh8>(c, slots, st);
  else if (c.flavor == kEyeMegaBdpt)
    err = launch_trace<kEyeMegaBdpt, kEngineBvh8>(c, slots, st);
  else if (c.engine == kEngineThreaded)
    err = launch_trace<kEyeClassic, kEngineThreaded>(c, slots, st);
  else
    err = launch_trace<kEyeClassic, kEngineBvh8>(c, slots, st);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
