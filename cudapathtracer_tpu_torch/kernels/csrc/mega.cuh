// K14's strategies: the pieces in which the mega engines' eye pass, in its
// VCM and BDPT flavours, differs from the classic one (vcm.cuh). The staged
// passes (eye.cuh) call them: s=0 under BDPT's weights and NEE in the eye
// walk, resolve in the connections, the merge in the gather.
//
// Replaces the strategies of cudapathtracer_tpu/models/vcm_mega.py:
// _mk_eye_machine (line 322) with _pack_conn_table (148), and of its BDPT
// flavour (models/bdpt_mega.py:render_sample, line 56). The JAX machine's
// lane schedule (refill queue, mini/full transitions, retirement slots, the
// compacted deferred merge) is TPU mechanism and is not ported: every eye
// draw is keyed by the path's list index g and its depth (id g * 64 +
// depth; BSDF draws 0-3 and NEE's 16-18 of the eye key) and the primary ray
// by the pixel id, so one thread per path gives the JAX image.
//
// Where the mega estimator differs from the classic eye pass (vcm.cuh):
// NEE and the connections use the eye normal turned toward the previous
// vertex and the direction normalize(prev - pos); NEE traces only where
// cos_light >= EPSILON, to dist - EPSILON skipping the light's triangle;
// each weighted contribution is scaled by its shadow ray AFTER the weight,
// then clamped (VCM) or not (BDPT); the merge sums its slots from zero and
// adds the sum, ((beta f) thr) (merge_norm w) per photon; BDPT's s=0 at
// depth 0 weighs against the camera-trace pdf, unclamped. A blocked shadow
// ray adds nothing (the JAX engine adds a zero).
#pragma once

#include <cstdint>

#include "vcm.cuh"

namespace tpt {

constexpr uint32_t kMegaIdStride = 64;

// A weighted contribution scaled by its (unblocked) shadow ray.
template <bool kBdpt>
__device__ __forceinline__ V3 resolve(const Weighting& wt, V3 pending,
                                      const Trace8& sh) {
  if (wt.paint_weight) return pending;  // the ray only gates
  const V3 s = mul(pending, v3(sh.s0, sh.s1, sh.s2));
  return kBdpt ? s : clamp_firefly(s);
}

// s = 0 under BDPT's weights (e: the shade-time vertex).
__device__ __forceinline__ V3 implicit_bdpt(const SceneRefs& sc,
                                            const EyeParams& p,
                                            int32_t light_ind,
                                            const EyeVertex& e, V3 prev_pt,
                                            bool prev_delta, int depth) {
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float* lr = light_row(sc.lights.rows, light_ind);
  const float area = __ldg(lr + 15);
  const float cos_la = fabsf(dot(e.n, e.to_prev));
  V3 contrib = mul(row_v3(lr, 12), e.thr);
  const float pdf_connect0 = (1.0f / num) / fmaxf(area, 1e-20f);
  float w_eye;
  if (depth == 0) {
    const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
    const float cos_cam = fabsf(dot(fwd, neg(e.to_prev)));
    const float d2n = fmaxf(length_sq(sub(e.pos, prev_pt)), 1e-20f);
    const float pdf_trace_cam =
        cos_la / (d2n * p.plane_area * cube(cos_cam));
    w_eye = pdf_connect0 / fmaxf(pdf_trace_cam, 1e-20f);
  } else {
    const float pdf_c = prev_delta ? 0.0f : pdf_connect0;
    w_eye = pdf_c * e.d_vcm + pdf_c * (cos_la / kPi) * e.d_vc;
    const float lum = luminance(contrib);
    if (lum > kMaxFireflyLum)
      contrib = scale(contrib, kMaxFireflyLum / fmaxf(lum, 1e-20f));
  }
  return p.weighting(contrib, 1.0f / (1.0f + w_eye));
}

// NEE (s = 1) at eye vertex e (its normal turned toward the previous
// vertex, fe its frame; m its lobe) on BVH8; did: the draw id. The BSDF
// terms and the weighted contribution are computed before the trace, so
// only that contribution lives across it. Returns the resolved
// contribution, zero where nothing is traced or the ray is blocked.
template <bool kBdpt, class S>
__device__ __forceinline__ V3 nee_mega(const SceneRefs& sc,
                                       const EyeParams& p, const EyeVertex& e,
                                       const Frame& fe, const S& m,
                                       uint32_t did, int32_t& rays,
                                       int32_t& rows) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const TableDraws nd{p.nee_keys, did};
  const LightPoint lp = light_point(nd, sc);
  const V3 stl = sub(lp.p, e.pos);
  const float d2 = fmaxf(length_sq(stl), kRayEps);
  const float dist = sqrtf(d2);
  const V3 stl_u = v3(stl.x / dist, stl.y / dist, stl.z / dist);
  const float cos_light = dot(lp.n, neg(stl_u));
  if (!(cos_light >= kEps)) return zero;
  const V3 origin = add(e.pos, scale(e.n, kRayEps));
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float cos_surf = fabsf(dot(e.n, stl_u));
  const float g = fminf(cos_light * cos_surf / d2, kMaxGNee);
  const float pdf_connect = (1.0f / num) / fmaxf(lp.area, 1e-20f);
  const float pdf_emit_sa = cos_light / kPi;
  const V3 stl_local = to_local(stl_u, fe);
  const V3 to_prev_loc = to_local(e.to_prev, fe);
  const BsdfEval be = bsdf_eval<true, true>(m, to_prev_loc, stl_local, 1.0f);
  const V3 contrib = scale(mul(be.f, lp.le), g / pdf_connect);
  const float pdf_bsdf_area = be.pdf * fabsf(cos_light) / d2;
  const float ratio = pdf_bsdf_area / fmaxf(pdf_connect, 1e-20f);
  const float w_light = kBdpt ? ratio : ratio * ratio;
  const float pdf_curr_rev_area = pdf_emit_sa * fabsf(stl_local.z) / d2;
  const float w_eye =
      pdf_curr_rev_area * (p.eta_vcm + e.d_vcm + be.pdf_rev * e.d_vc);
  const float weight = 1.0f / (1.0f + w_light + w_eye);
  const V3 pending = p.weighting(mul(contrib, e.thr), weight);
  ++rays;
  const Trace8 sh = trace8<true>(sc.table, sc.tri_f32, sc.tri_cols, origin.x,
                                 origin.y, origin.z, stl_u.x, stl_u.y,
                                 stl_u.z, dist - kEps, lp.tri, true);
  rows += sh.rows;
  if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f)) return zero;
  return resolve<kBdpt>(p.weighting, pending, sh);
}

// The merge at eye vertex e (shade-time normal; m: its lobe): its
// candidates' sum from zero (fold_neighbors: for cap <= 8 the photons
// neighbor_slots' candidate slots hold, in their order); adds the cap's
// dropped photons. The vertex's frame and its direction to the previous
// vertex are resolved once, not per photon.
__device__ __forceinline__ V3 merge_mega(const EyeParams& p,
                                         const GridRefs& g,
                                         const EyeVertex& e,
                                         const SurfHeld& m,
                                         int32_t& dropped) {
  const Frame fe = frame(e.n);
  const V3 prev_loc = to_local(e.to_prev, fe);
  const float eta = fmaxf(p.eta_vcm, 1e-30f);
  V3 li_m = v3(0.0f, 0.0f, 0.0f);
  dropped += fold_neighbors(g, e.pos, [&](const Photon& ph, float w) {
    float weight;
    const V3 base = merge_term(e, m, fe, prev_loc, ph, eta, weight);
    li_m = add(li_m, p.weighting(scale(base, p.merge_norm * w), weight));
  });
  return li_m;
}

}  // namespace tpt
