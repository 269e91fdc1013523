// K13's VCM form with the K9 merge: the per-thread body of the VCM / SPPM
// eye pass (tpt::vcm_eye_pixel), which vcm_eye.cu launches one thread per
// pixel.
//
// Replaces the eye pass of cudapathtracer_tpu/models/vcm.py:render_sample
// (line 150, lines 229-459). The eye walk of eye_depth bounces is carried
// on the fly, in registers (nothing stored): raygen (K7) -> closest hit
// (K1) -> the sky term on a miss -> hit fetch (K2) -> the BSDF sample (K3)
// BEFORE the strategies -> the MIS step with eta_vcm (mis.cuh) -> s=0 (the
// walk hit a light), s=1 (NEE keyed fold_in(bounce_key, 7)), s>=2 (every
// stored light vertex of K12's light buffers, all light_depth rows), the
// merge (hashgrid.cuh fold_neighbors) -> continue, or end after the first
// non-delta surface under SPPM. Each contribution is added in that order,
// as the JAX wavefront sums them per lane.
//
// Kept quirks of the JAX estimator (models/vcm.py): no eta_vcm in the s=0
// weight; depth 0 exempt from the s=0 firefly clamp; NEE's w_light the
// squared ratio; the clamp on every s>=1 contribution; cos >= EPSILON in
// the connections; the previous vertex's direction normalize(prev - pos);
// d_vcm / max(eta_vcm, 1e-30) in the merge weights; NEE's prev-to-current
// direction is the unnormalized pos - prev_pt in the local frame.
//
// Engines: vcm_eye_pixel and the connection ray are templates on the
// traversal engine (traverse_bin.cuh); vcm_eye.cu launches the scene's,
// and K14 (mega.cuh) instantiates the connection ray with BVH8.
#pragma once

#include <cstdint>

#include "bdpt.cuh"
#include "hashgrid.cuh"

namespace tpt {

struct VcmParams {
  CameraParams cam;         // raygen (camera draw keys inside)
  float plane_area;
  uint32_t key_e0, key_e1;  // the eye key: bounce keys fold_in(key_e, depth)
  int eye_depth, light_depth;
  bool naive, nee, connection, merge, sppm, sample_environment;
  Weighting weighting;
  float eta_vcm, merge_norm;
};

struct VcmIn {
  PathBufs light;   // [light_depth, N], the VCM light walk's buffers
  GridRefs grid;    // rows null without the merge
  const float* fb;  // nullable: the splat, added to the result
};

__device__ __forceinline__ V3 clamp_firefly(V3 c) {
  const float lum = luminance(c);
  return lum > kMaxFireflyLum ? scale(c, kMaxFireflyLum / fmaxf(lum, 1e-20f))
                              : c;
}

// The eye vertex the strategies of one bounce share.
struct EyeVertex {
  V3 pos, n, albedo, thr, to_prev;
  float trans, d_vcm, d_vc, d_vm;
  Mat m;
};

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
  const Mat ml = mat_of(sc, lv.mat_id);
  const V3 albedo_l = resolve_albedo(sc.textures, ml, lv.u, lv.v);
  const float trans_l = resolve_transmission(sc.textures, ml, lv.u, lv.v);
  const V3 l2e_loc_l = to_local(neg(e2l_u), lv.n);
  const V3 to_l_from_prev_loc = to_local(neg(lv.wo), lv.n);
  const V3 l2e_loc_e = to_local(neg(e2l_u), e.n);
  const V3 to_prev_loc_e = to_local(e.to_prev, e.n);

  const float pdf_eye_rev_sa =
      bsdf_pdf(ml, neg(to_l_from_prev_loc), l2e_loc_l, 1.0f, trans_l);
  const float pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2;
  const float pdf_bef_eye_rev_sa =
      bsdf_pdf(e.m, neg(l2e_loc_e), to_prev_loc_e, 1.0f, e.trans);
  const float pdf_light_rev_sa =
      bsdf_pdf(e.m, to_prev_loc_e, neg(l2e_loc_e), 1.0f, e.trans);
  const float pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2;
  const float pdf_bef_light_rev_sa =
      bsdf_pdf(ml, l2e_loc_l, neg(to_l_from_prev_loc), 1.0f, trans_l);
  const float w_eye = pdf_eye_rev_area *
                      (eta_vcm + e.d_vcm + pdf_bef_eye_rev_sa * e.d_vc);
  const float w_light =
      pdf_light_rev_area *
      (eta_vcm + lv.d_vcm + pdf_bef_light_rev_sa * lv.d_vc);
  weight = 1.0f / (1.0f + w_eye + w_light);

  const V3 f_eye =
      bsdf_f(e.m, e.albedo, neg(l2e_loc_e), to_prev_loc_e, 1.0f, e.trans);
  const V3 f_light = bsdf_f(ml, albedo_l, l2e_loc_l, neg(to_l_from_prev_loc),
                            1.0f, trans_l);
  const float gg = fminf(cos_e * cos_l / d2, kMaxGConnect);
  return scale(mul(mul(mul(e.thr, lv.beta), f_eye), f_light), gg);
}

// s >= 2 against stored light vertex j; adds into li, counts the ray.
template <int kEngine>
__device__ __forceinline__ void connect_vcm(const SceneRefs& sc,
                                            const VcmParams& p,
                                            const VcmIn& in,
                                            const EyeVertex& e, int j,
                                            int64_t i, V3& li, int32_t& rays,
                                            int32_t& rows) {
  const Vertex lv = load_vertex(in.light, j, i);
  ConnRay c;
  if (!conn_ray<kEngine>(sc, e, lv, c, rays, rows)) return;
  if (!(max3(c.sh.s0, c.sh.s1, c.sh.s2) > 0.0f)) return;
  float weight;
  const V3 base = conn_terms(sc, p.eta_vcm, e, lv, c, weight);
  const V3 contrib = mul(base, v3(c.sh.s0, c.sh.s1, c.sh.s2));
  li = add(li, clamp_firefly(p.weighting(contrib, weight)));
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
  const float* lr = sc.lights.rows + 17 * static_cast<int64_t>(light_ind);
  const float area = __ldg(lr + 15);
  const float cos_l = dot(e.n, e.to_prev);
  const float pdf_connect =
      prev_delta ? 0.0f : (1.0f / num) / fmaxf(area, 1e-20f);
  const float w_eye =
      pdf_connect * e.d_vcm + pdf_connect * (cos_l / kPi) * e.d_vc;
  const V3 out = wt(mul(row_v3(lr, 12), e.thr), 1.0f / (1.0f + w_eye));
  return depth > 0 ? clamp_firefly(out) : out;
}

// The merge of photon ph at eye vertex e (prev_loc: the direction to the
// previous vertex in e's frame): returns (beta_p f) thr and its MIS weight.
__device__ __forceinline__ V3 merge_term(const EyeVertex& e, V3 prev_loc,
                                         const Photon& ph, float eta,
                                         float& weight) {
  const V3 wi_loc = to_local(ph.wi, e.n);
  const V3 f = bsdf_f(e.m, e.albedo, wi_loc, prev_loc, 1.0f, e.trans);
  const float pdf_eye_rev = bsdf_pdf(e.m, wi_loc, prev_loc, 1.0f, e.trans);
  const float pdf_light_rev = bsdf_pdf(e.m, prev_loc, wi_loc, 1.0f, e.trans);
  const float w_eye = e.d_vcm / eta + pdf_eye_rev * e.d_vm;
  const float w_light = ph.d_vcm / eta + pdf_light_rev * ph.d_vm;
  weight = 1.0f / (1.0f + w_eye + w_light);
  return mul(mul(ph.beta, f), e.thr);
}

// The eye pass of pixel (px, py), path i: returns its radiance plus the
// splat fb[i]; adds its rays and BVH8 rows, sets its dropped photons.
template <int kEngine>
__device__ __forceinline__ V3 vcm_eye_pixel(const SceneRefs& sc,
                                            const VcmParams& p,
                                            const VcmIn& in, int64_t i,
                                            int32_t px, int32_t py,
                                            int32_t& rays, int32_t& rows,
                                            int32_t& dropped) {
  const uint32_t id = static_cast<uint32_t>((py << 14) + px);
  const Weighting& wt = p.weighting;
  float org[3], dir[3];
  camera_ray(p.cam, static_cast<float>(px), static_cast<float>(py), id, org,
             dir);
  V3 o = v3(org[0], org[1], org[2]);
  V3 d = v3(dir[0], dir[1], dir[2]);
  const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
  const float cos_cam = fabsf(dot(fwd, d));
  float prev_pdf = 1.0f / (p.plane_area * cube(cos_cam));
  float prev_cos = cos_cam;
  V3 thr = v3(1.0f, 1.0f, 1.0f), prev_pt = o;
  bool prev_delta = true;
  MisState ms;
  ms.d_vcm = ms.d_vc = ms.d_vm = ms.pdf_rev_prev = 0.0f;
  ms.prev_was_delta = false;
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  V3 li = v3(0.0f, 0.0f, 0.0f);

  for (int depth = 0; depth < p.eye_depth; ++depth) {
    ++rays;
    const Trace8 h = trace_ray<kEngine, false>(sc, o.x, o.y, o.z, d.x, d.y,
                                               d.z, kBigT, -1, true);
    rows += h.rows;
    if (h.tri < 0) {  // escaped: the sky, weight 1
      if (p.sample_environment)
        li = add(li, wt(mul(thr, sample_sky(d, true)), 1.0f));
      break;
    }
    const ShadeHit s =
        shade_fetch(sc.tri_f32, sc.tri_cols, h.tri, h.u, h.v, o, d, h.t);
    EyeVertex e;
    e.m = s.mat;
    e.pos = s.point;
    e.n = s.normal;
    e.thr = thr;
    const V3 wo_local = to_local(d, e.n);
    e.albedo = resolve_albedo(sc.textures, s);
    e.trans = resolve_transmission(sc.textures, s);
    const bool cur_delta = e.m.is_specular;

    const float d2p = fmaxf(length_sq(sub(e.pos, prev_pt)), kRayEps);
    const float pdf_fwd_area = prev_pdf * fabsf(wo_local.z) / d2p;
    const float g = prev_cos / d2p;
    const KeyDraws bd = fold_draws(p.key_e0, p.key_e1,
                                   static_cast<uint32_t>(depth), id);
    const Sample bs = bsdf_sample(bd, e.m, e.albedo, neg(wo_local),
                                  s.backface, 1.0f, e.trans, true);
    const float pdf_rev_sa = bsdf_pdf(e.m, bs.wo, neg(wo_local), 1.0f,
                                      e.trans);
    const bool valid = bs.pdf >= kEps;
    const MisState mv = mis_advance(
        ms, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
        1.0f / fmaxf(pdf_fwd_area, 1e-20f), 0.0f, 0.0f, true, p.eta_vcm);
    e.d_vcm = mv.d_vcm;
    e.d_vc = mv.d_vc;
    e.d_vm = mv.d_vm;
    e.to_prev = normalize(sub(prev_pt, e.pos));

    if (valid && !cur_delta) {
      // s = 0: the eye walk hit a light (no eta_vcm in this weight)
      if (p.naive && s.light_ind >= 0 && !s.backface)
        li = add(li, implicit_vcm(sc, wt, s.light_ind, e, prev_delta, depth));

      // s = 1: NEE; w_light the squared pdf ratio
      const V3 ptc_local = to_local(sub(e.pos, prev_pt), e.n);
      if (p.nee && sc.lights.count > 0) {
        ++rays;
        const KeyDraws kk = fold_draws(bd.k0, bd.k1, 7u, id);
        const LightPoint lp = light_point(kk, sc);
        const V3 stl = sub(lp.p, e.pos);
        const float d2 = fmaxf(length_sq(stl), kRayEps);
        const float dist = sqrtf(d2);
        const V3 stl_u = v3(stl.x / dist, stl.y / dist, stl.z / dist);
        const V3 origin = add(e.pos, scale(e.n, kRayEps));
        const Trace8 sh = trace_ray<kEngine, true>(
            sc, origin.x, origin.y, origin.z, stl_u.x, stl_u.y, stl_u.z,
            dist - kEps, lp.tri, true);
        rows += sh.rows;
        const float cos_light = dot(lp.n, neg(stl_u));
        if (max3(sh.s0, sh.s1, sh.s2) > 0.0f && cos_light >= kEps) {
          const float cos_surf = fabsf(dot(e.n, stl_u));
          const float gn = fminf(cos_light * cos_surf / d2, kMaxGNee);
          const float pdf_connect = (1.0f / num) / fmaxf(lp.area, 1e-20f);
          const float pdf_emit_sa = cos_light / kPi;
          const V3 stl_local = to_local(stl_u, e.n);
          const V3 f = bsdf_f(e.m, e.albedo, neg(ptc_local), stl_local, 1.0f,
                              e.trans);
          const V3 contrib =
              scale(mul(mul(v3(sh.s0, sh.s1, sh.s2), f), lp.le),
                    gn / pdf_connect);
          const float pdf_bsdf_sa =
              bsdf_pdf(e.m, neg(ptc_local), stl_local, 1.0f, e.trans);
          const float pdf_bsdf_area = pdf_bsdf_sa * fabsf(cos_light) / d2;
          const float ratio = pdf_bsdf_area / fmaxf(pdf_connect, 1e-20f);
          const float w_light = ratio * ratio;
          const float pdf_curr_rev_area =
              pdf_emit_sa * fabsf(stl_local.z) / d2;
          const float pdf_prev_rev_sa =
              bsdf_pdf(e.m, stl_local, neg(ptc_local), 1.0f, e.trans);
          const float w_eye = pdf_curr_rev_area *
                              (p.eta_vcm + e.d_vcm + pdf_prev_rev_sa * e.d_vc);
          const float weight = 1.0f / (1.0f + w_light + w_eye);
          li = add(li, clamp_firefly(wt(mul(contrib, thr), weight)));
        }
      }

      // s >= 2: every stored light vertex of this path id
      if (p.connection)
        for (int j = 0; j < p.light_depth; ++j)
          connect_vcm<kEngine>(sc, p, in, e, j, i, li, rays, rows);

      // the merge with the photons around the vertex
      if (p.merge) {
        const V3 prev_loc = to_local(e.to_prev, e.n);
        const float eta = fmaxf(p.eta_vcm, 1e-30f);
        dropped += fold_neighbors(in.grid, e.pos, [&](const Photon& ph,
                                                      float w) {
          float weight;
          const V3 base = merge_term(e, prev_loc, ph, eta, weight);
          li = add(li, wt(scale(scale(base, p.merge_norm), w), weight));
        });
      }
    }

    // continue the walk; SPPM ends it after its first non-delta surface
    if (!valid) break;
    thr = scale(mul(thr, bs.f), fabsf(bs.wo.z) / fmaxf(bs.pdf, 1e-20f));
    const V3 wi_world = normalize(to_world(bs.wo, e.n));
    const float side = dot(wi_world, e.n) < 0.0f ? -1.0f : 1.0f;
    o = add(e.pos, scale(e.n, side * kRayEps));
    d = wi_world;
    prev_pdf = bs.pdf;
    prev_cos = fabsf(bs.wo.z);
    prev_pt = e.pos;
    prev_delta = cur_delta;
    if (p.sppm && p.merge && !cur_delta) break;
  }
  if (in.fb != nullptr) li = add(li, get3(in.fb, i));
  return li;
}

// ---- host side: the C entry's argument block -------------------------------

struct VcmLaunch {
  SceneRefs sc;
  VcmParams p;
  VcmIn in;
  const int32_t* px;
  const int32_t* py;
  float* out;
  int32_t* rays;
  int32_t* dropped;
  int32_t* rows;
  int64_t n;
  int engine;
};

// Layouts at the entry in vcm_eye.cu.
inline bool vcm_launch(const int64_t* ptrs, const int64_t* iv,
                       const float* fv, const uint32_t* keys, VcmLaunch& c) {
  c.n = iv[0];
  c.sc.table = dev_ptr<const float>(ptrs, 0);
  c.sc.tri_f32 = dev_ptr<const float>(ptrs, 1);
  c.sc.tri_cols = static_cast<int>(iv[1]);
  c.sc.lights.rows = dev_ptr<const float>(ptrs, 2);
  c.sc.lights.count = static_cast<int32_t>(iv[2]);
  c.sc.mat_f32 = dev_ptr<const float>(ptrs, 3);
  c.sc.textures = dev_ptr<const float>(ptrs, 4);
  c.px = dev_ptr<const int32_t>(ptrs, 5);
  c.py = dev_ptr<const int32_t>(ptrs, 6);
  VcmParams& p = c.p;
  p.cam = make_camera(fv, keys);
  p.plane_area = fv[19];
  p.eta_vcm = fv[20];
  p.merge_norm = fv[21];
  p.key_e0 = keys[10];
  p.key_e1 = keys[11];
  p.eye_depth = static_cast<int>(iv[3]);
  p.light_depth = static_cast<int>(iv[4]);
  p.naive = iv[5] != 0;
  p.nee = iv[6] != 0;
  p.connection = iv[7] != 0;
  p.weighting.do_mis = iv[8] != 0;
  p.weighting.paint_weight = iv[9] != 0;
  p.sample_environment = iv[10] != 0;
  p.merge = iv[11] != 0;
  p.sppm = iv[12] != 0;
  c.in.light = path_bufs(ptrs + 7, c.n, p.light_depth);
  GridRefs& g = c.in.grid;
  g.rows = dev_ptr<const float>(ptrs, 18);
  g.cell_se = dev_ptr<const int32_t>(ptrs, 19);
  g.geom.table_size = static_cast<uint32_t>(iv[13]);
  g.cap = static_cast<int>(iv[14]);
  g.one_brick = iv[15] != 0;
  g.reweight = iv[16] != 0;
  g.n_rows = 0;  // the fold reads no brick
  for (int k = 0; k < 3; ++k) g.geom.smin[k] = fv[22 + k];
  g.geom.cell_size = fv[25];
  g.r2 = fv[26];
  c.in.fb = dev_ptr<const float>(ptrs, 20);
  c.out = dev_ptr<float>(ptrs, 21);
  c.rays = dev_ptr<int32_t>(ptrs, 22);
  c.dropped = dev_ptr<int32_t>(ptrs, 23);
  c.rows = dev_ptr<int32_t>(ptrs, 24);
  c.engine = engine_refs(ptrs, 25, iv, 17, c.sc);
  const bool grid_ok = !p.merge || (g.rows != nullptr &&
                                    g.cell_se != nullptr &&
                                    g.geom.table_size > 0 && g.cap >= 1);
  return p.eye_depth >= 1 && p.light_depth >= 1 && grid_ok &&
         c.engine >= 0;
}

// One pixel of the eye pass, as the kernel runs it.
template <int kEngine>
__device__ __forceinline__ void vcm_eye_one(const VcmLaunch& c, int64_t i) {
  int32_t r = 0, w = 0, dr = 0;
  put3(c.out, i, vcm_eye_pixel<kEngine>(c.sc, c.p, c.in, i, c.px[i],
                                        c.py[i], r, w, dr));
  c.rays[i] += r;
  c.dropped[i] = dr;
  if (c.rows != nullptr) c.rows[i] += w;
}

}  // namespace tpt
