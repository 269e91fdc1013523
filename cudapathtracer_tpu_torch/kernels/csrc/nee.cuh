// K4 device code: next-event estimation, power-2 MIS, the sky and the
// nested-dielectric medium stack of one path.
//
// Replaces cudapathtracer_tpu/ops/lanemajor.py:499-666 (power2_weight 499,
// sample_skyT 506, nee_pdfT 517, sample_light_pointT 539, nee_sampleT 560,
// stack_pushT 621, stack_removeT 630, dominant_mediumT 644, table_lookup3T
// 667) and their row-major twins in models/common.py:26-217. The JAX
// versions hold the medium stack as a [16, N] array and update it with
// one-hot masks; here it is one path's 16 entries in registers or local
// memory. second_lowest_mediumT (654) feeds only the engines' eta_t state,
// which no lobe reads, so the kernel neither keeps eta_t nor calls it.
//
// Bound: a light-table row read (68 bytes), three Threefry draws and a BSDF
// evaluation per NEE sample; arithmetic and one scattered read, small
// beside the shadow ray it launches (K1).
// Design: NEE stops before the shadow trace and returns the ray, its
// unshadowed contribution and the BSDF's pdf (one fused evaluation), so
// the caller finishes the event before it traces the ray with K1's device
// function and weighs the result in the order its schedule needs. The
// medium stack keeps the reference quirks:
// packed (priority << 10 | mat_id) entries, slot 0 never removed, the
// shift-down on removal as a roll (the last slot takes slot 0's entry).
#pragma once

#include <cstdint>

#include "bsdf.cuh"
#include "shade.cuh"

namespace tpt {

constexpr int kMediumStack = 16;       // models/common.py MEDIUM_STACK_SIZE
constexpr int32_t kNoMedium = 1 << 30;  // packed entry that never wins a min

// Power-2 MIS heuristic p^2/(p^2+q^2) in the overflow-safe form.
__device__ __forceinline__ float power2_weight(float p, float q) {
  const float r = q / fmaxf(p, 1e-30f);
  const float w = 1.0f / (1.0f + r * r);
  return p > 0.0f ? w : 0.0f;
}

// Gradient sky; the reference ships it disabled (black).
__device__ __forceinline__ V3 sample_sky(V3 d, bool enabled) {
  if (!enabled) return v3(0.0f, 0.0f, 0.0f);
  const V3 unit = normalize(d);
  const float t = 0.5f * (unit.y + 1.0f);
  return v3((1.0f - t) * 1.0f + t * 0.3f, (1.0f - t) * 0.4f + t * 0.4f,
            (1.0f - t) * 0.2f + t * 0.8f);
}

__device__ __forceinline__ float signed_clamp(float x, float eps) {
  const float sign = x >= 0.0f ? 1.0f : -1.0f;
  return sign * fmaxf(fabsf(x), eps);
}

// Solid-angle pdf of NEE picking this light point from `from`:
// d^2 / (cos_l * num_lights * A); negative when the light faces away.
__device__ __forceinline__ float nee_pdf(V3 from, V3 lp, V3 ln, float area,
                                         float num_lights) {
  const V3 stl = sub(lp, from);
  const V3 wi = normalize(stl);
  const float d2 = length_sq(stl);
  const float cos_l = dot(ln, neg(wi));
  const float denom = cos_l * num_lights * area;
  return d2 / signed_clamp(denom, 1e-20f);
}

// The scene's lights: light_f32 [L, 17] (p0, p1, p2, vertex-a normal,
// emission, area, triangle), num_lights = max(L, 1) as a float.
struct Lights {
  const float* rows;
  int32_t count;  // number of lights in the scene (0: no NEE)
};

struct NeeSample {
  V3 contrib;       // f * Le * cos / pdf, gated, unshadowed
  float light_pdf;
  float bsdf_pdf;   // the BSDF's pdf of the light direction (if active)
  V3 wo_local;      // light direction in shading space
  V3 origin, dir;   // the shadow ray
  float max_t;
  bool active;      // worth tracing
};

// Light pick + area sample (draws base+0..2 through draw(k)) and the
// unshadowed NEE contribution from `point` in shading frame fr. wi_local:
// the incoming ray in shading space (the caller's to_local(d, fr)); m: the
// hit's lobe (bsdf.cuh Surf or SurfHeld), evaluated once for f and the
// pdf.
template <class Draw, class S>
__device__ __forceinline__ NeeSample nee_sample(
    const Draw& draw, const Lights& lights, V3 point, const Frame& fr,
    V3 wi_local, const S& m, float eta_i, bool active) {
  const float num = static_cast<float>(lights.count > 1 ? lights.count : 1);
  const float ul = draw(0);
  const float u = sqrtf(draw(1));
  const float v = draw(2);
  int32_t idx = static_cast<int32_t>(ul * num);
  const int32_t last = (lights.count > 1 ? lights.count : 1) - 1;
  idx = idx < last ? idx : last;
  const float* r = light_row(lights.rows, idx);
  const V3 a = row_v3(r, 0), b = row_v3(r, 3), c = row_v3(r, 6);
  const float wa = 1.0f - u, wb = u * (1.0f - v), wc = u * v;
  const V3 lp = add(add(scale(a, wa), scale(b, wb)), scale(c, wc));
  const V3 ln = row_v3(r, 9);
  const float larea = __ldg(r + 15);

  NeeSample ns;
  const V3 stl = sub(lp, point);
  const V3 wi = normalize(stl);
  const float dist = sqrtf(fmaxf(length_sq(stl), 0.0f));
  ns.origin = add(point, scale(wi, kEps));
  // measured from the offset origin; the extra EPSILON keeps the light
  // itself outside the occlusion test
  ns.max_t = (dist - kEps) * (1.0f - kEps);
  ns.dir = wi;
  ns.light_pdf = nee_pdf(point, lp, ln, larea, num);
  const float cos_surf = fabsf(dot(fr.n, wi));
  ns.wo_local = to_local(wi, fr);
  ns.active = (ns.light_pdf > kEps) && active;
  ns.bsdf_pdf = 0.0f;
  if (ns.active) {
    const BsdfEval e =
        bsdf_eval<true, false>(m, neg(wi_local), ns.wo_local, eta_i);
    ns.bsdf_pdf = e.pdf;
    ns.contrib = scale(mul(e.f, row_v3(r, 12)),
                       cos_surf / signed_clamp(ns.light_pdf, 1e-20f));
  } else {
    ns.contrib = v3(0.0f, 0.0f, 0.0f);
  }
  return ns;
}

// ---- the medium stack ------------------------------------------------------

struct MediumStack {
  int32_t s[kMediumStack];
  int top;

  __device__ __forceinline__ void init(int32_t air_priority) {
#pragma unroll
    for (int k = 0; k < kMediumStack; ++k) s[k] = 0;
    s[0] = air_priority << 10;
    top = 1;
  }

  __device__ __forceinline__ void push(int32_t mat_id, int32_t priority) {
    if (top < kMediumStack) {
      s[top] = (priority << 10) | mat_id;
      ++top;
    }
  }

  // Remove the topmost occurrence of mat_id (never slot 0), shifting the
  // entries above it down; the last slot takes slot 0's entry (a roll).
  __device__ __forceinline__ void remove(int32_t mat_id) {
    int found = -1;
#pragma unroll
    for (int k = 1; k < kMediumStack; ++k)
      if (k < top && (s[k] & 1023) == mat_id) found = k;
    if (found < 0) return;
    const int32_t first = s[0];
#pragma unroll
    for (int k = 1; k < kMediumStack - 1; ++k)
      if (k >= found) s[k] = s[k + 1];
    s[kMediumStack - 1] = first;
    --top;
  }

  // The lowest-priority-value medium (equal priorities: the lowest
  // mat_id); packed min over the live entries.
  __device__ __forceinline__ int32_t dominant() const {
    int32_t best = kNoMedium;
#pragma unroll
    for (int k = 0; k < kMediumStack; ++k)
      if (k < top && s[k] < best) best = s[k];
    return best;
  }
};

}  // namespace tpt
