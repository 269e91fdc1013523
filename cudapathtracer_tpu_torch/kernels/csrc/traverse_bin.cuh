// K15 device code: the threaded stackless binary-BVH engine, closest-hit
// and any-hit shadow traversal of one ray, and the engine choice of the
// kernels that trace rays.
//
// Replaces cudapathtracer_tpu/ops/traverse.py:closest_hit (line 132) and
// shadow_factor (line 203); trace_fused (line 293) is the two calls there
// and here. The JAX engine advances the whole wavefront one node a step in
// lockstep, each lane holding one int32 cursor, with straggler compaction
// and a one-hot octant select to keep TPU lanes busy; here one thread owns
// one ray and loops until its cursor is -1.
//
// Table: scene/scene.py's node_packed, one row per binary node of node_w
// floats (24 + 10 leaf_k rounded up to 8): [0:6] box (min xyz, max xyz),
// [6:14] hit link per octant, [14:22] miss link per octant, [22] leaf
// triangle count (0 = inner), [24 + 9k] inline triangle k (v0, e1, e2),
// [24 + 9 leaf_k + k] its id (bit 30 MAT_LEAF, -1 empty); ints as bits.
// node_w and leaf_k are runtime values: the build's force-leaf fallback can
// make a leaf larger than the configured leaf size.
//
// The walk is the JAX one, so the results are the same ids:
//  * slab-test the node's box; it is hit when tmax >= tmin, tmax > 0 and
//    tmin < t_best (closest) or < max_t (shadow);
//  * a hit inner node continues at the ray octant's hit link (the near
//    child); anything else at the octant's miss link (-1 ends the walk);
//  * a hit leaf tests its count triangles in slot order: closest keeps a
//    hit with t < t_best strictly (ties go to the first slot), shadow
//    multiplies each MAT_LEAF triangle's transmission in and stops at an
//    opaque hit or once the product's max falls below 0.01.
// Moller-Trumbore, the MAT_LEAF transmission product and safe_inv are
// traverse8.cuh's, so both engines round alike under -fmad=false.
//
// Bound: counted, the slab and triangle tests of the rows visited (the
// table, 18 MB at 1080p, is read far fewer times than rows are visited:
// the top of the tree stays in L1/L2); in practice the latency of each
// dependent row fetch. Design: a visit reads only the box and the links
// (the first 32 bytes, two 16-byte loads) and the count, and a leaf's
// triangles only when its box is hit; no stack, so no local memory. A
// ray visits ~10x the rows of the BVH8 table (a binary tree, every missed
// box a row), and neighbouring threads diverge on their thread lengths.
#pragma once

#include <cstdint>

#include "traverse8.cuh"

namespace tpt {

// The traversal engine a kernel instantiation uses.
constexpr int kEngineBvh8 = 0;      // K1, bvh8_table
constexpr int kEngineThreaded = 1;  // K15, node_packed

// Host side: whether a launch's engine arguments are valid: BVH8, or
// threaded with a node table whose rows (node_w a multiple of 8) hold
// 24 + 10 leaf_k floats.
inline bool engine_ok(int engine, const float* nodes, int node_w,
                      int leaf_k) {
  return engine == kEngineBvh8 ||
         (engine == kEngineThreaded && nodes != nullptr && leaf_k >= 1 &&
          node_w % 8 == 0 && node_w >= 24 + 10 * leaf_k);
}

template <bool kShadow>
__device__ __forceinline__ Trace8 trace_bin(
    const float* __restrict__ nodes, int node_w, int leaf_k,
    const float* __restrict__ tri_f32, int tri_cols, float ox, float oy,
    float oz, float dx, float dy, float dz, float max_t, int32_t skip_tri,
    bool active) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const int oct = (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) |
                  (dz < 0.0f ? 4 : 0);
  float t_best = max_t;
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  float s0 = 1.0f, s1 = 1.0f, s2 = 1.0f;
  int rows = 0;
  int32_t cur = active ? 0 : -1;
  while (cur >= 0) {
    ++rows;
    const float* row = nodes + static_cast<int64_t>(cur) * node_w;
    const int32_t* irow = reinterpret_cast<const int32_t*>(row);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
    const float t1x = (b0.x - ox) * ix, t2x = (b0.w - ox) * ix;
    const float t1y = (b0.y - oy) * iy, t2y = (b1.x - oy) * iy;
    const float t1z = (b0.z - oz) * iz, t2z = (b1.y - oz) * iz;
    const float tmin =
        fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tmax =
        fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool hit = (tmax >= tmin) && (tmax > 0.0f) &&
                     (tmin < (kShadow ? max_t : t_best));
    const int32_t count = __ldg(irow + 22);
    if (!hit || count == 0) {
      cur = __ldg(irow + (hit ? 6 : 14) + oct);
      continue;
    }
    const int32_t* ids = irow + 24 + 9 * leaf_k;
    bool blocked = false;
    for (int k = 0; k < count; ++k) {
      float p[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) p[q] = __ldg(row + 24 + 9 * k + q);
      const LeafTri tr =
          moller_trumbore(p, __ldg(ids + k), ox, oy, oz, dx, dy, dz,
                          kShadow ? max_t : t_best, skip_tri);
      if (!tr.ok) continue;
      if (!kShadow) {
        t_best = tr.t;
        best_tri = tr.tid;
        best_u = tr.u;
        best_v = tr.v;
        continue;
      }
      if (!(tr.raw & kLeafMatFlag)) {  // opaque
        blocked = true;
        break;
      }
      float a0, a1, a2;
      leaf_transmission(tri_f32, tri_cols, tr, dx, dy, dz, a0, a1, a2);
      s0 = s0 * a0;
      s1 = s1 * a1;
      s2 = s2 * a2;
      if (fmaxf(fmaxf(s0, s1), s2) < 0.01f) {
        blocked = true;
        break;
      }
    }
    if (kShadow && blocked) {  // occlusion is final
      s0 = s1 = s2 = 0.0f;
      break;
    }
    cur = __ldg(irow + 14 + oct);
  }
  Trace8 r;
  r.t = t_best;
  r.tri = best_tri;
  r.u = best_u;
  r.v = best_v;
  r.s0 = s0;
  r.s1 = s1;
  r.s2 = s2;
  r.restarts = 0;
  r.rows = rows;
  return r;
}

// One ray on the engine kEngine of a scene record Sc that holds both
// engines' tables (table; nodes, node_w, leaf_k) and the triangle block
// (tri_f32, tri_cols; read by shadow rays for MAT_LEAF transmission only).
template <int kEngine, bool kShadow, class Sc>
__device__ __forceinline__ Trace8 trace_ray(const Sc& sc, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float max_t,
                                            int32_t skip_tri, bool active) {
  const float* tri = kShadow ? sc.tri_f32 : nullptr;
  const int cols = kShadow ? sc.tri_cols : 0;
  if constexpr (kEngine == kEngineThreaded) {
    return trace_bin<kShadow>(sc.nodes, sc.node_w, sc.leaf_k, tri, cols, ox,
                              oy, oz, dx, dy, dz, max_t, skip_tri, active);
  } else {
    return trace8<kShadow>(sc.table, tri, cols, ox, oy, oz, dx, dy, dz,
                           max_t, skip_tri, active);
  }
}

}  // namespace tpt
