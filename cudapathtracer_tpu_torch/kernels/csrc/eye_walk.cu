// Stage 1 of the VCM eye passes: the eye walk, one thread per path
// (tpt::eye_walk_one, eye.cuh), in the classic VCM / SPPM flavour on the
// scene's engine and in K14's VCM and BDPT flavours on BVH8.
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
// the records are written depth-major ([D, N]: a warp's 32 paths store
// neighbouring words). The classic flavour's draws take their pairs from a key
// table a small kernel folds from the eye key first (keys.cuh eye_key_tables:
// per depth the BSDF pairs of bounce_key(key_e, depth) and NEE's of
// fold_in(bounce key, 7)): one cipher a draw, where each depth folded its
// bounce key, NEE's key and each draw's pair in the lane (11 ciphers more a
// depth with NEE before). ptxas (H100 build): 64 registers at the minimum of
// blocks below (127-128 on BVH8 and 122 threaded, 4 blocks, before the shading
// code read its material by id). chip_smoke.py prints the report.

#include <cuda_runtime.h>

#include <cstdint>

#include "eye.cuh"

namespace {

constexpr int kThreads = 128;

// At a minimum of kMinBlocks blocks of 128 an SM (64 registers, spills
// cached): the walk advanced and NEE's terms computed before its shadow
// ray leave the trace few live values, and the warps pay (a 1080p VCM
// sample's walk 20.6 ms at 8, 20.9 at 10, 21.3 at 6, 22.3 at 5, 24.1 at
// ptxas' own count; H100, tools/shade_attribution.py).
constexpr int kMinBlocks = 8;
template <int kFlavor, int kEngine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    eye_walk_kernel(tpt::EyeLaunch c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c.n) return;
  tpt::eye_walk_one<kFlavor, kEngine>(c, i);
}

}  // namespace

// The argument layout is eye.cuh's (tpt::eye_launch). Returns the launch's
// cudaError_t.
extern "C" int tpt_eye_walk(const int64_t* ptrs, const int64_t* iv,
                            const float* fv, const uint32_t* keys,
                            void* stream) {
  tpt::EyeLaunch c;
  if (!tpt::eye_launch(ptrs, iv, fv, keys, c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace tpt;
  if (c.flavor == kEyeClassic)
    launch_key_table(eye_key_tables(c.p.key_e0, c.p.key_e1, c.p.eye_depth),
                     dev_ptr<KeyPair>(ptrs, 41), st);
  if (c.flavor == kEyeMegaVcm)
    eye_walk_kernel<kEyeMegaVcm, kEngineBvh8><<<blocks, kThreads, 0, st>>>(c);
  else if (c.flavor == kEyeMegaBdpt)
    eye_walk_kernel<kEyeMegaBdpt, kEngineBvh8><<<blocks, kThreads, 0, st>>>(
        c);
  else if (c.engine == kEngineThreaded)
    eye_walk_kernel<kEyeClassic, kEngineThreaded>
        <<<blocks, kThreads, 0, st>>>(c);
  else
    eye_walk_kernel<kEyeClassic, kEngineBvh8><<<blocks, kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
