// The strategies of the VCM eye passes (K13's VCM form with the K9
// merge, and K14's shared pieces): the eye vertex, NEE under VCM's
// weights, the connection to one light vertex (its shadow ray and its
// weighted terms), s=0 under VCM's weights and one photon's merge term.
// The staged passes (eye.cuh: the eye walk, the connections, the merge
// and gather) call them; mega.cuh adds K14's forms.
//
// Replaces the strategies of cudapathtracer_tpu/models/vcm.py:
// render_sample (line 150, lines 229-459): s=0 (the walk hit a light),
// s=1 (NEE keyed fold_in(bounce_key, 7)), s>=2 (a stored light vertex of
// K12's light buffers) and the merge term of the fold.
//
// Kept quirks of the JAX estimator (models/vcm.py): no eta_vcm in the s=0
// weight; depth 0 exempt from the s=0 firefly clamp; NEE's w_light the
// squared ratio; the clamp on every s>=1 contribution; cos >= EPSILON in
// the connections; the previous vertex's direction normalize(prev - pos);
// d_vcm / max(eta_vcm, 1e-30) in the merge weights; NEE's prev-to-current
// direction is the unnormalized pos - prev_pt in the local frame.
//
// Engines: NEE and the connection ray are templates on the traversal
// engine (traverse_bin.cuh); the classic pass instantiates the scene's,
// and K14 BVH8.
#pragma once

#include <cstdint>

#include "bdpt.cuh"
#include "hashgrid.cuh"

namespace tpt {

// The parameters of an eye pass, classic or mega (eye.cuh reads the
// flavour's fields).
struct EyeParams {
  CameraParams cam;         // raygen (camera draw keys inside)
  float plane_area;
  uint32_t key_e0, key_e1;  // classic: key_e (the prologue folds the table)
  const KeyPair* key_table;  // classic: [eye_depth][7] (eye_key_tables)
  uint32_t bsdf_keys[8];    // mega: draw_key(key_e, 0..3)
  uint32_t nee_keys[6];     // mega: draw_key(key_e, 16..18)
  int eye_depth, light_rows;
  bool naive, nee, connection, merge, sppm, sample_environment;
  Weighting weighting;
  float eta_vcm, merge_norm;
  int64_t gbase;            // mega: the chunk's first list index
};

__device__ __forceinline__ V3 clamp_firefly(V3 c) {
  const float lum = luminance(c);
  return lum > kMaxFireflyLum ? scale(c, kMaxFireflyLum / fmaxf(lum, 1e-20f))
                              : c;
}

// The eye vertex the strategies of one bounce share: its material is
// mat_id's row of mat_f32 with the albedo and transmission the walk
// resolved (held_of).
struct EyeVertex {
  V3 pos, n, albedo, thr, to_prev;
  float trans, d_vcm, d_vc, d_vm;
  int32_t mat_id;
};

// The fields of e's lobe, in registers (bsdf.cuh SurfHeld).
__device__ __forceinline__ SurfHeld held_of(const SceneRefs& sc,
                                            const EyeVertex& e) {
  return surf_held(sc.mat_f32, e.mat_id, e.albedo, e.trans);
}

// The geometry of the connection of eye vertex e with light vertex lv, and
// its shadow ray (to dist - RAY_EPSILON from pos + n RAY_EPSILON): false if
// the light vertex is invalid or delta or a cosine is below EPSILON (no
// ray), else traced (one ray counted).
struct ConnRay {
  V3 e2l_u;
  float d2, cos_l, cos_e;
  Trace8 sh;
};

template <int kEngine>
__device__ __forceinline__ bool conn_ray(const SceneRefs& sc,
                                         const EyeVertex& e, const Vertex& lv,
                                         ConnRay& c, int32_t& rays,
                                         int32_t& rows) {
  if (!lv.valid || lv.is_delta) return false;
  const V3 e2l = sub(lv.pt, e.pos);
  c.d2 = fmaxf(length_sq(e2l), kRayEps);
  const float dist = sqrtf(c.d2);
  c.e2l_u = v3(e2l.x / dist, e2l.y / dist, e2l.z / dist);
  c.cos_l = fabsf(dot(lv.n, neg(c.e2l_u)));
  c.cos_e = fabsf(dot(e.n, c.e2l_u));
  if (!(c.cos_l >= kEps && c.cos_e >= kEps)) return false;
  const V3 origin = add(e.pos, scale(e.n, kRayEps));
  ++rays;
  c.sh = trace_ray<kEngine, true>(sc, origin.x, origin.y, origin.z,
                                  c.e2l_u.x, c.e2l_u.y, c.e2l_u.z,
                                  dist - kRayEps, -1, true);
  rows += c.sh.rows;
  return true;
}

// The unshadowed connection (((thr beta_l) f_eye) f_light) G and its MIS
// weight with eta_vcm (0 under BDPT's weights).
__device__ __forceinline__ V3 conn_terms(const SceneRefs& sc, float eta_vcm,
                                         const EyeVertex& e, const Vertex& lv,
                                         const ConnRay& c, float& weight) {
  const V3 e2l_u = c.e2l_u;
  const float d2 = c.d2, cos_l = c.cos_l, cos_e = c.cos_e;
  const Frame fl = frame(lv.n), fe = frame(e.n);
  const V3 l2e_loc_l = to_local(neg(e2l_u), fl);
  const V3 to_l_from_prev_loc = to_local(neg(lv.wo), fl);
  const V3 l2e_loc_e = to_local(neg(e2l_u), fe);
  const V3 to_prev_loc_e = to_local(e.to_prev, fe);
  // one evaluation a side (f and the pdfs of both directions)
  const BsdfEval bl =
      bsdf_eval<true, true>(surf_of(sc, lv.mat_id, lv.u, lv.v), l2e_loc_l,
                            neg(to_l_from_prev_loc), 1.0f);
  const BsdfEval be = bsdf_eval<true, true>(held_of(sc, e), neg(l2e_loc_e),
                                            to_prev_loc_e, 1.0f);

  const float pdf_eye_rev_sa = bl.pdf_rev;
  const float pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2;
  const float pdf_bef_eye_rev_sa = be.pdf;
  const float pdf_light_rev_sa = be.pdf_rev;
  const float pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2;
  const float pdf_bef_light_rev_sa = bl.pdf;
  const float w_eye = pdf_eye_rev_area *
                      (eta_vcm + e.d_vcm + pdf_bef_eye_rev_sa * e.d_vc);
  const float w_light =
      pdf_light_rev_area *
      (eta_vcm + lv.d_vcm + pdf_bef_light_rev_sa * lv.d_vc);
  weight = 1.0f / (1.0f + w_eye + w_light);

  const V3 f_eye = be.f;
  const V3 f_light = bl.f;
  const float gg = fminf(cos_e * cos_l / d2, kMaxGConnect);
  return scale(mul(mul(mul(e.thr, lv.beta), f_eye), f_light), gg);
}

// s = 1 under VCM's weights at eye vertex e (its shade-time normal, fe its
// frame; m its lobe): the light point drawn by kk (the pairs of fold_in(bounce
// key, 7), the eye walk's key table), one shadow ray to dist - EPSILON skipping
// the light's triangle (counted), w_light the squared ratio; ptc_local: pos -
// prev_pt in e's frame. The BSDF terms and the weight are computed before the
// trace, so only they live across it. Returns the clamped weighted
// contribution, zero where the ray is blocked or the light faces away.
template <int kEngine, class S, class Draw>
__device__ __forceinline__ V3 nee_vcm(const SceneRefs& sc,
                                      const Weighting& wt, float eta_vcm,
                                      const EyeVertex& e, const Frame& fe,
                                      const S& m, const Draw& kk,
                                      V3 ptc_local, int32_t& rays,
                                      int32_t& rows) {
  ++rays;
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const LightPoint lp = light_point(kk, sc);
  const V3 stl = sub(lp.p, e.pos);
  const float d2 = fmaxf(length_sq(stl), kRayEps);
  const float dist = sqrtf(d2);
  const V3 stl_u = v3(stl.x / dist, stl.y / dist, stl.z / dist);
  const V3 origin = add(e.pos, scale(e.n, kRayEps));
  const float cos_light = dot(lp.n, neg(stl_u));
  const float cos_surf = fabsf(dot(e.n, stl_u));
  const float gn = fminf(cos_light * cos_surf / d2, kMaxGNee);
  const float pdf_connect = (1.0f / num) / fmaxf(lp.area, 1e-20f);
  const float pdf_emit_sa = cos_light / kPi;
  const V3 stl_local = to_local(stl_u, fe);
  const BsdfEval be =
      bsdf_eval<true, true>(m, neg(ptc_local), stl_local, 1.0f);
  const float pdf_bsdf_area = be.pdf * fabsf(cos_light) / d2;
  const float ratio = pdf_bsdf_area / fmaxf(pdf_connect, 1e-20f);
  const float w_light = ratio * ratio;
  const float pdf_curr_rev_area = pdf_emit_sa * fabsf(stl_local.z) / d2;
  const float w_eye =
      pdf_curr_rev_area * (eta_vcm + e.d_vcm + be.pdf_rev * e.d_vc);
  const float weight = 1.0f / (1.0f + w_light + w_eye);
  const float gs = gn / pdf_connect;
  const Trace8 sh = trace_ray<kEngine, true>(sc, origin.x, origin.y,
                                             origin.z, stl_u.x, stl_u.y,
                                             stl_u.z, dist - kEps, lp.tri,
                                             true);
  rows += sh.rows;
  if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f && cos_light >= kEps))
    return v3(0.0f, 0.0f, 0.0f);
  const V3 contrib =
      scale(mul(mul(v3(sh.s0, sh.s1, sh.s2), be.f), lp.le), gs);
  return clamp_firefly(wt(mul(contrib, e.thr), weight));
}

// s = 0 under VCM's weights at eye vertex e (its shade-time normal), a
// light seen from the front: no eta_vcm in the weight, depth 0 exempt from
// the firefly clamp.
__device__ __forceinline__ V3 implicit_vcm(const SceneRefs& sc,
                                           const Weighting& wt,
                                           int32_t light_ind,
                                           const EyeVertex& e,
                                           bool prev_delta, int depth) {
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float* lr = light_row(sc.lights.rows, light_ind);
  const float area = __ldg(lr + 15);
  const float cos_l = dot(e.n, e.to_prev);
  const float pdf_connect =
      prev_delta ? 0.0f : (1.0f / num) / fmaxf(area, 1e-20f);
  const float w_eye =
      pdf_connect * e.d_vcm + pdf_connect * (cos_l / kPi) * e.d_vc;
  const V3 out = wt(mul(row_v3(lr, 12), e.thr), 1.0f / (1.0f + w_eye));
  return depth > 0 ? clamp_firefly(out) : out;
}

// The merge of photon ph at eye vertex e (m: its lobe, fe: its frame,
// prev_loc: the direction to the previous vertex in it): returns (beta_p f)
// thr and its MIS weight. One fused evaluation gives f and both pdfs.
template <class S>
__device__ __forceinline__ V3 merge_term(const EyeVertex& e, const S& m,
                                         const Frame& fe, V3 prev_loc,
                                         const Photon& ph, float eta,
                                         float& weight) {
  const V3 wi_loc = to_local(ph.wi, fe);
  const BsdfEval b = bsdf_eval<true, true>(m, wi_loc, prev_loc, 1.0f);
  const float w_eye = e.d_vcm / eta + b.pdf * e.d_vm;
  const float w_light = ph.d_vcm / eta + b.pdf_rev * ph.d_vm;
  weight = 1.0f / (1.0f + w_eye + w_light);
  return mul(mul(ph.beta, b.f), e.thr);
}

}  // namespace tpt
