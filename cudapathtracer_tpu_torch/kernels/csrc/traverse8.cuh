// K1 device code: BVH8 closest-hit and any-hit shadow traversal of one ray.
//
// Replaces cudapathtracer_tpu/ops/traverse8.py:closest_hit8 (line 288) and
// shadow_factor8 (line 354) with their step helpers _pop, _node_stage,
// _sort8_keys, _push_block, _leaf_tris, _leaf_closest and _leaf_shadow, and
// the behaviour of make_fused_step / trace_fused8 (lines 466, 536): those
// advanced a mixed wavefront of closest and shadow lanes in lockstep, one
// row per step, with the stack as a [16, N] array shifted per push. Here one
// thread owns one ray and loops until its stack drains; the mixing of
// closest and shadow lanes is TPU mechanism, so a caller (traverse8.cu's
// entry points, uni_mega.cu's per-path loop) simply calls trace8 for the
// ray it has.
//
// Table: scene/bvh8.py's hybrid CBVH rows, [R, 96] float32: [0:48] child
// boxes (minx[8] miny[8] minz[8] maxx[8] maxy[8] maxz[8]), [48] child base
// (int bits), [50:86] four inline triangles (v0, e1, e2), [86:90] their ids
// (int bits, bit 30 = MAT_LEAF, -1 = empty).
//
// Bound: memory latency. Each step is one dependent 384-byte row fetch
// (then a child row that depends on it), and rays diverge, so neighbouring
// threads read unrelated rows; the arithmetic per row (8 slab tests, a
// 19-comparator sort, 4 Moller-Trumbore tests) is small beside it. So the
// hosts' occupancy decides how much latency is hidden, and trace8 is
// inlined into every host kernel: its live values are the host's
// registers.
// Design: the row is consumed in stages: the child boxes one axis at a
// time (two 16-byte loads of minima and two of maxima, folded into 8
// running near / far t's), then the 8 keys sorted in registers by the same
// 19-comparator network, then the 4 inline triangles one at a time, each
// read (8-byte loads) and tested only when its id word is >= 0, the row's
// winner kept as it goes. At most ~40 row
// values are live instead of ~110 (48 box floats, 40 triangle floats, four
// results), which took 21-23 registers off the hosts (uni_mega 146 -> 125,
// the eye walk 148 -> 125-128) and up to 17% of their time (K5, the eye
// walk; tools/k1_attribution.py). The stack is a ring of kStackD entries
// in local memory (L1), so an overflow keeps the newest entries exactly as
// the JAX shift did; a [kStackD][128] slab in shared memory (8 KB a block)
// measured 6-8% slower in K5 and the eye walk and at most 2% faster
// elsewhere. kStackD is 16, the JAX default; -DTPT_STACK_D=<n> builds
// another depth, as the JAX package's TPT_STACK_D does (tests build 7 to
// drive the overflow path).
// The traversal order is the JAX one, so the results are the same ids, not
// just the same closest distance:
//  * child key = (tmin bits, negatives flipped, & ~7) | slot, ascending;
//    enter the nearest child directly, push the others far to near;
//  * overflow marks the ray; once its stack drains it restarts from the root
//    (closest: keeping t_best; shadow: scale reset to 1), at most 3 times;
//  * inline triangles: t < t_cut strictly, tid != skip_tri; the row's winner
//    is the smallest (t bits & ~3) | slot, so near-ties go to the first slot;
//  * shadow: per row, the product over MAT_LEAF triangles of
//    albedo * transmission * (1 - Schlick(interpolated normal)); any opaque
//    hit, or a product whose max falls below 0.01, blocks the ray.
// FMA: every file that includes this is built with -fmad=false (see
// kernels/__init__.py), so each product is rounded before its sum as in the
// plain PyTorch version and XLA:CPU; with contraction on, Moller-Trumbore's
// u, v and t move by an ulp and rays through a shared edge can pick the
// other triangle.
#pragma once

#include <cstdint>

#ifndef TPT_STACK_D
#define TPT_STACK_D 16
#endif

namespace tpt {

constexpr int kRowW = 96;
constexpr int kTriOff = 50;
constexpr int kLeafTris = 4;
constexpr int kStackD = TPT_STACK_D;
static_assert(kStackD >= 7, "one row pushes up to 7 entries");
constexpr int kMaxRestarts = 3;
constexpr int32_t kKeyInvalid = 0x7FFFFFFF;
constexpr int32_t kLeafMatFlag = 1 << 30;
constexpr float kDetEps = 1e-12f;
constexpr float kBigT = 999999.0f;  // ops/intersect.py BIG_T

__device__ __forceinline__ float safe_inv(float d) {
  const float s = d >= 0.0f ? 1.0f : -1.0f;
  return s / fmaxf(fabsf(d), 1e-30f);
}

__device__ __forceinline__ void cswap(int32_t& a, int32_t& b) {
  const int32_t lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// Batcher odd-even merge network for 8 keys (traverse8.py _SORT8).
__device__ __forceinline__ void sort8(int32_t k[8]) {
  cswap(k[0], k[1]); cswap(k[2], k[3]); cswap(k[4], k[5]); cswap(k[6], k[7]);
  cswap(k[0], k[2]); cswap(k[1], k[3]); cswap(k[4], k[6]); cswap(k[5], k[7]);
  cswap(k[1], k[2]); cswap(k[5], k[6]);
  cswap(k[0], k[4]); cswap(k[1], k[5]); cswap(k[2], k[6]); cswap(k[3], k[7]);
  cswap(k[2], k[4]); cswap(k[3], k[5]);
  cswap(k[1], k[2]); cswap(k[3], k[4]); cswap(k[5], k[6]);
}

struct LeafTri {
  float t, u, v;
  int32_t tid, raw;
  bool ok;
};

// Moller-Trumbore of the ray (o, d) against the packed triangle p[0:9]
// (v0, e1, e2) whose id word is raw (bit 30 MAT_LEAF, < 0 empty): ok when
// it is hit at 0 < t < t_cut, and its id is >= 0 and not skip_tri. The
// threaded engine (traverse_bin.cuh) tests its leaves with it too.
__device__ __forceinline__ LeafTri moller_trumbore(const float* p,
                                                   int32_t raw, float ox,
                                                   float oy, float oz,
                                                   float dx, float dy,
                                                   float dz, float t_cut,
                                                   int32_t skip_tri) {
  const float v0x = p[0], v0y = p[1], v0z = p[2];
  const float e1x = p[3], e1y = p[4], e1z = p[5];
  const float e2x = p[6], e2y = p[7], e2z = p[8];
  const int32_t tid = raw < 0 ? -1 : (raw & ~kLeafMatFlag);
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = hx * e1x + hy * e1y + hz * e1z;
  const bool ok_det = fabsf(a) >= kDetEps;
  const float f = 1.0f / (ok_det ? a : 1.0f);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  LeafTri r;
  r.t = t;
  r.u = u;
  r.v = v;
  r.tid = tid;
  r.raw = raw;
  r.ok = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
         tid >= 0 && t < t_cut && tid != skip_tri;
  return r;
}

// The transmission of the MAT_LEAF triangle hit in tr, crossed by the
// direction d: albedo * (transmission * (1 - Schlick)) through the
// interpolated normal, from tri_f32[78:94] (vertex normals a, b, c;
// albedo; transmission; ior). Both engines multiply it in.
__device__ __forceinline__ void leaf_transmission(
    const float* __restrict__ tri_f32, int tri_cols, const LeafTri& tr,
    float dx, float dy, float dz, float& a0, float& a1, float& a2) {
  const float* sr = tri_f32 + static_cast<int64_t>(tr.tid) * tri_cols + 78;
  const float u = tr.u, v = tr.v;
  const float w0 = 1.0f - u - v;
  const float nx = sr[0] * w0 + sr[3] * u + sr[6] * v;
  const float ny = sr[1] * w0 + sr[4] * u + sr[7] * v;
  const float nz = sr[2] * w0 + sr[5] * u + sr[8] * v;
  const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
  const float cos_t = fabsf(dx * nx + dy * ny + dz * nz) * inv_len;
  const float ior = sr[13];
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float x = 1.0f - cos_t;
  const float x2 = x * x;
  const float fres = r0 + (1.0f - r0) * (x * (x2 * x2));
  const float tmul = sr[12] * (1.0f - fres);
  a0 = sr[9] * tmul;
  a1 = sr[10] * tmul;
  a2 = sr[11] * tmul;
}

// One ray's result: closest (t, tri, u, v; tri = -1 and t = max_t on a
// miss) or shadow (scale, 1 clear, 0 occluded, else the transmission), its
// number of restarts from the root and of rows it visited.
struct Trace8 {
  float t, u, v;
  int32_t tri;
  float s0, s1, s2;
  int restarts, rows;
};

// The slab test of one axis of the row's 8 children: lo / hi are the
// axis's 8 minima / maxima (two float4 each), o and inv the ray's origin
// and inverse direction on it. The first axis sets tn / tf (first),
// later ones narrow them, in the JAX order (max of the near t's, min of
// the far t's, x then y then z).
__device__ __forceinline__ void slab_axis(const float4* row4, int lo, int hi,
                                          float o, float inv, float tn[8],
                                          float tf[8], bool first) {
  const float4 a0 = __ldg(row4 + lo), a1 = __ldg(row4 + lo + 1);
  const float4 b0 = __ldg(row4 + hi), b1 = __ldg(row4 + hi + 1);
  const float mn[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float mx[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float t1 = (mn[s] - o) * inv, t2 = (mx[s] - o) * inv;
    tn[s] = first ? fminf(t1, t2) : fmaxf(tn[s], fminf(t1, t2));
    tf[s] = first ? fmaxf(t1, t2) : fminf(tf[s], fmaxf(t1, t2));
  }
}

// Inline triangle j of a row (floats [50 + 9j, 59 + 9j): v0, e1, e2), read
// with the 8-byte loads its offset allows.
__device__ __forceinline__ void load_leaf_tri(const float* row, int j,
                                              float p[9]) {
  const float* q = row + kTriOff + 9 * j;
  const int odd = j & 1;  // an odd slot starts on an odd float
  if (odd) p[0] = __ldg(q);
  const float2* q2 = reinterpret_cast<const float2*>(q + odd);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float2 f = __ldg(q2 + w);
    p[odd + 2 * w] = f.x;
    p[odd + 2 * w + 1] = f.y;
  }
  if (!odd) p[8] = __ldg(q + 8);
}

// tri_f32 / tri_cols: the scene's triangle block, read by shadow rays for
// MAT_LEAF transmission only (columns 78:94).
template <bool kShadow>
__device__ __forceinline__ Trace8 trace8(const float* __restrict__ table,
                                         const float* __restrict__ tri_f32,
                                         int tri_cols, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float max_t,
                                         int32_t skip_tri, bool active) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_cut = max_t;  // closest: running t_best; shadow: max_t
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  float s0 = 1.0f, s1 = 1.0f, s2 = 1.0f;

  int32_t direct = active ? 0 : -1;
  int top = 0;        // live entries (<= kStackD)
  uint32_t sp = 0u;   // ring write position
  int lostc = 0;      // bit 0: pending loss; bits 1+: restarts
  int rows = 0;
  int32_t stack[kStackD];

  while (direct >= 0 || top > 0) {
    ++rows;
    int32_t entry;
    if (direct >= 0) {
      entry = direct;
    } else {
      --sp;
      entry = stack[sp % kStackD];
      --top;
    }
    const float* row = table + static_cast<int64_t>(entry) * kRowW;
    const float4* row4 = reinterpret_cast<const float4*>(row);

    // ---- child stage: slab-test 8 slots, sort packed keys
    int32_t key[8];
    {  // one axis at a time: 16 box floats live, not 48
      float tn[8], tf[8];
      slab_axis(row4, 0, 6, ox, ix, tn, tf, true);
      slab_axis(row4, 2, 8, oy, iy, tn, tf, false);
      slab_axis(row4, 4, 10, oz, iz, tn, tf, false);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const bool hit = (tf[s] >= tn[s]) && (tf[s] > 0.0f) && (tn[s] < t_cut);
        int32_t tb = __float_as_int(tn[s]);
        if (tb < 0) tb ^= 0x7FFFFFFF;
        key[s] = hit ? ((tb & ~7) | s) : kKeyInvalid;
      }
    }
    const int32_t base = __float_as_int(__ldg(row + 48));
    sort8(key);
    const int32_t new_direct =
        key[0] != kKeyInvalid ? base + (key[0] & 7) : -1;
    int count = 0;
#pragma unroll
    for (int s = 1; s < 8; ++s) count += key[s] != kKeyInvalid;
    // push deferred key[1..count] far to near: key[1] ends on top
#pragma unroll
    for (int s = 7; s >= 1; --s) {
      if (s <= count) {
        stack[sp % kStackD] = base + (key[s] & 7);
        ++sp;
      }
    }
    if (top + count > kStackD) lostc |= 1;
    top = top + count < kStackD ? top + count : kStackD;

    // ---- inline-triangle stage: Moller-Trumbore on up to 4 triangles,
    // every test against the t_cut the row started with
    const float t_row = t_cut;
    // one triangle at a time, and only the slots whose id word is >= 0
    const float2* ids2 = reinterpret_cast<const float2*>(row + 86);
    const float2 id01 = __ldg(ids2), id23 = __ldg(ids2 + 1);
    const int32_t raw[kLeafTris] = {__float_as_int(id01.x),
                                    __float_as_int(id01.y),
                                    __float_as_int(id23.x),
                                    __float_as_int(id23.y)};
    int32_t kmin = kKeyInvalid;
    float f0 = 1.0f, f1 = 1.0f, f2 = 1.0f;
    bool opaque = false, any_leaf = false;
#pragma unroll
    for (int j = 0; j < kLeafTris; ++j) {
      if (raw[j] < 0 || opaque) continue;
      float p[9];
      load_leaf_tri(row, j, p);
      const LeafTri tr = moller_trumbore(p, raw[j], ox, oy, oz, dx, dy, dz,
                                         t_row, skip_tri);
      if (!tr.ok) continue;
      if (!kShadow) {
        // the row's winner: the smallest (t bits & ~3) | slot
        const int32_t k = (__float_as_int(fmaxf(tr.t, 0.0f)) & ~3) | j;
        if (k < kmin) {
          kmin = k;
          t_cut = tr.t;
          best_tri = tr.tid;
          best_u = tr.u;
          best_v = tr.v;
        }
      } else if (!(tr.raw & kLeafMatFlag)) {
        opaque = true;  // occlusion is final: the rest cannot matter
      } else {
        float a0, a1, a2;
        leaf_transmission(tri_f32, tri_cols, tr, dx, dy, dz, a0, a1, a2);
        f0 = f0 * a0;
        f1 = f1 * a1;
        f2 = f2 * a2;
        any_leaf = true;
      }
    }
    if (kShadow) {
      s0 = s0 * f0;
      s1 = s1 * f1;
      s2 = s2 * f2;
      const bool dark = fmaxf(fmaxf(s0, s1), s2) < 0.01f;
      if (opaque || (any_leaf && dark)) {  // occlusion is final
        s0 = s1 = s2 = 0.0f;
        break;
      }
    }

    direct = new_direct;
    // drained with a pending loss: restart from the root
    if (direct < 0 && top <= 0 && (lostc & 1) &&
        (lostc >> 1) < kMaxRestarts) {
      direct = 0;
      lostc = ((lostc >> 1) + 1) << 1;
      if (kShadow) s0 = s1 = s2 = 1.0f;
    }
  }

  Trace8 r;
  r.t = t_cut;
  r.tri = best_tri;
  r.u = best_u;
  r.v = best_v;
  r.s0 = s0;
  r.s1 = s1;
  r.s2 = s2;
  r.restarts = lostc >> 1;
  r.rows = rows;
  return r;
}

}  // namespace tpt
