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
// Tables: ops/traverse.py's bin_table, derived once a scene from
// scene/scene.py's node_packed (whose layout is the JAX package's) by
// ops/traverse.threaded_table, one float block (ints as bits):
//   head [M] records of 96 bytes (six float4s): the node's box (min xyz,
//        max xyz), two zero words, then per octant o the pair (hit word,
//        miss link): the hit word is the octant's hit link for an inner
//        node, -2 - s for a leaf whose triangles start at slot s;
//   tris [S] records of 48 bytes (three float4s), after head: v0, e1, e2,
//        the id word (bit 30 MAT_LEAF), 1 on the leaf's last triangle.
//
// The walk is the JAX one, so the results are the same ids:
//  * slab-test the node's box; it is hit when tmax >= tmin, tmax > 0 and
//    tmin < t_best (closest) or < max_t (shadow);
//  * a hit inner node continues at the ray octant's hit link (the near
//    child); anything else at the octant's miss link (-1 ends the walk);
//  * a hit leaf tests its triangles in slot order: closest keeps a hit
//    with t < t_best strictly (ties go to the first slot), shadow
//    multiplies each MAT_LEAF triangle's transmission in and stops at an
//    opaque hit or once the product's max falls below 0.01.
// Moller-Trumbore, the MAT_LEAF transmission product and safe_inv are
// traverse8.cuh's, so both engines round alike under -fmad=false.
//
// Bound: counted, the slab and triangle tests of the rows visited (the
// tables, 13 MB at 1080p, are read far fewer times than rows are
// visited: the top of the tree stays in L1/L2); in practice the latency
// of each dependent row fetch, ~67 a primary ray. Design: a visit is
// three 16-byte loads issued together, the box and the octant's link
// pair, two 32-byte sectors of one record, and the next cursor is a
// select between the pair's words, not a load that waits for the slab
// test (node_packed's 192-byte rows spread a visit over 2-3 sectors and a
// second round trip). The records keep every octant's links beside the
// box: incoherent rays at one node share its record, which a table per
// octant (32-byte records, one sector a visit) would split into 8, 8
// times the footprint; they take half node_packed's (8.9 against 17.9 MB
// at 1080p). A hit leaf's triangles are three 16-byte loads each
// (node_packed's 9 scalar loads at a 36-byte stride), its length the last
// flag. No stack, so no local memory. A ray visits ~10x the rows of the
// BVH8 table (a binary tree, every missed box a row), and neighbouring
// threads diverge on their thread lengths.
#pragma once

#include <cstdint>

#include "traverse8.cuh"

namespace tpt {

// float4s a node record of bin_table
constexpr int kBinQuads = 6;

// The traversal engine a kernel instantiation uses.
constexpr int kEngineBvh8 = 0;      // K1, bvh8_table
constexpr int kEngineThreaded = 1;  // K15, bin_table

// Host side: whether a launch's engine arguments are valid: BVH8, or
// threaded with a table of nodes >= 1 records and slots >= 1 triangles.
inline bool engine_ok(int engine, const float* bin, int64_t nodes,
                      int64_t slots) {
  return engine == kEngineBvh8 ||
         (engine == kEngineThreaded && bin != nullptr && nodes >= 1 &&
          slots >= 1);
}

template <bool kShadow>
__device__ __forceinline__ Trace8 trace_bin(
    const float* __restrict__ bin, int32_t nodes,
    const float* __restrict__ tri_f32, int tri_cols, float ox, float oy,
    float oz, float dx, float dy, float dz, float max_t, int32_t skip_tri,
    bool active) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const int oct = (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) |
                  (dz < 0.0f ? 4 : 0);
  const float4* head = reinterpret_cast<const float4*>(bin);
  const float4* tris = head + kBinQuads * static_cast<int64_t>(nodes);
  const int pair = 2 + (oct >> 1);  // the float4 of the octant's links
  float t_best = max_t;
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  float s0 = 1.0f, s1 = 1.0f, s2 = 1.0f;
  int rows = 0;
  int32_t cur = active ? 0 : -1;
  while (cur >= 0) {
    ++rows;
    const float4* rec = head + kBinQuads * static_cast<int64_t>(cur);
    const float4 b0 = __ldg(rec), b1 = __ldg(rec + 1);
    const float4 lk = __ldg(rec + pair);
    const float t1x = (b0.x - ox) * ix, t2x = (b0.w - ox) * ix;
    const float t1y = (b0.y - oy) * iy, t2y = (b1.x - oy) * iy;
    const float t1z = (b0.z - oz) * iz, t2z = (b1.y - oz) * iz;
    const float tmin =
        fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tmax =
        fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool hit = (tmax >= tmin) && (tmax > 0.0f) &&
                     (tmin < (kShadow ? max_t : t_best));
    const int32_t miss = __float_as_int((oct & 1) ? lk.w : lk.y);
    cur = hit ? __float_as_int((oct & 1) ? lk.z : lk.x) : miss;
    if (cur >= -1) continue;
    // a hit leaf: its triangles from slot -2 - cur, then the miss link
    bool blocked = false;
    for (const float4* tr = tris + 3 * static_cast<int64_t>(-2 - cur);;
         tr += 3) {
      const float4 q0 = __ldg(tr), q1 = __ldg(tr + 1), q2 = __ldg(tr + 2);
      const float p[9] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                          q1.y, q1.z, q1.w, q2.x};
      const LeafTri t =
          moller_trumbore(p, __float_as_int(q2.y), ox, oy, oz, dx, dy, dz,
                          kShadow ? max_t : t_best, skip_tri);
      if (t.ok) {
        if constexpr (!kShadow) {
          t_best = t.t;
          best_tri = t.tid;
          best_u = t.u;
          best_v = t.v;
        } else {
          if (!(t.raw & kLeafMatFlag)) {  // opaque
            blocked = true;
            break;
          }
          float a0, a1, a2;
          leaf_transmission(tri_f32, tri_cols, t, dx, dy, dz, a0, a1, a2);
          s0 = s0 * a0;
          s1 = s1 * a1;
          s2 = s2 * a2;
          if (fmaxf(fmaxf(s0, s1), s2) < 0.01f) {
            blocked = true;
            break;
          }
        }
      }
      if (__float_as_int(q2.z) != 0) break;  // the leaf's last triangle
    }
    if (kShadow && blocked) {  // occlusion is final
      s0 = s1 = s2 = 0.0f;
      break;
    }
    cur = miss;
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
// engines' tables (table; bin, bin_nodes) and the triangle block
// (tri_f32, tri_cols; read by shadow rays for MAT_LEAF transmission only).
template <int kEngine, bool kShadow, class Sc>
__device__ __forceinline__ Trace8 trace_ray(const Sc& sc, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float max_t,
                                            int32_t skip_tri, bool active) {
  const float* tri = kShadow ? sc.tri_f32 : nullptr;
  const int cols = kShadow ? sc.tri_cols : 0;
  if constexpr (kEngine == kEngineThreaded) {
    return trace_bin<kShadow>(sc.bin, sc.bin_nodes, tri, cols, ox, oy, oz,
                              dx, dy, dz, max_t, skip_tri, active);
  } else {
    return trace8<kShadow>(sc.table, tri, cols, ox, oy, oz, dx, dy, dz,
                           max_t, skip_tri, active);
  }
}

}  // namespace tpt
