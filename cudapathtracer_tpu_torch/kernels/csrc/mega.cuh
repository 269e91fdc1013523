// K14: the per-thread body of the mega engines' eye pass (tpt::mega_eye_pixel),
// which mega_eye.cu launches one thread per pixel of a chunk, in VCM's and
// BDPT's flavours.
//
// Replaces cudapathtracer_tpu/models/vcm_mega.py:_mk_eye_machine (line 322)
// with _pack_conn_table (148), and its BDPT flavour
// (models/bdpt_mega.py:render_sample, line 56). The JAX machine's lane
// schedule (refill queue, mini/full transitions, retirement slots, the
// compacted deferred merge) is TPU mechanism and is not ported: every eye
// draw is keyed by the path's list index g and its depth (id g * 64 +
// depth; BSDF draws 0-3 and NEE's 16-18 of the eye key) and the primary ray
// by the pixel id, so one thread per pixel in program order gives the JAX
// image. Per bounce: raygen (K7) -> closest hit (K1) -> the sky on a miss ->
// hit fetch (K2) -> the BSDF sample (K3) -> the MIS step (mis.cuh; the d_vm
// chain and eta_vcm under VCM) -> at a valid non-delta vertex: s=0 and the
// merge (hashgrid.cuh neighbor_slots, cap <= 8, else fold_neighbors), then
// NEE and the connections j = 0, 1, ... to the stored light vertices (K12's
// buffers read directly: _pack_conn_table's meaning, not its rows), each a
// shadow ray (K1) -> continue, or end (SPPM: after the first non-delta
// surface). The path's radiance retires through RGB9E5 (K10).
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
constexpr int kFlavorVcm = 0;
constexpr int kFlavorBdpt = 1;

struct MegaParams {
  CameraParams cam;         // raygen (camera draw keys inside)
  float plane_area;
  uint32_t bsdf_keys[8];    // draw_key(key_e, 0..3)
  uint32_t nee_keys[6];     // draw_key(key_e, 16..18)
  int eye_depth, light_rows;
  int flavor;
  bool naive, nee, connection, merge, sppm, sample_environment;
  Weighting weighting;
  float eta_vcm, merge_norm;
  int64_t gbase;            // the chunk's first list index
};

struct MegaIn {
  PathBufs light;   // [light_rows, c_pix], the chunk's light buffers
  GridRefs grid;    // rows null without the merge
};

// A weighted contribution scaled by its (unblocked) shadow ray.
__device__ __forceinline__ V3 resolve(const MegaParams& p, V3 pending,
                                      const Trace8& sh) {
  if (p.weighting.paint_weight) return pending;  // the ray only gates
  const V3 s = mul(pending, v3(sh.s0, sh.s1, sh.s2));
  return p.flavor == kFlavorBdpt ? s : clamp_firefly(s);
}

// s = 0 under BDPT's weights (e: the shade-time vertex).
__device__ __forceinline__ V3 implicit_bdpt(const SceneRefs& sc,
                                            const MegaParams& p,
                                            int32_t light_ind,
                                            const EyeVertex& e, V3 prev_pt,
                                            bool prev_delta, int depth) {
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float* lr = sc.lights.rows + 17 * static_cast<int64_t>(light_ind);
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
// vertex); did: the draw id.
__device__ __forceinline__ void nee_mega(const SceneRefs& sc,
                                         const MegaParams& p,
                                         const EyeVertex& e, uint32_t did,
                                         V3& li, int32_t& rays,
                                         int32_t& rows) {
  const TableDraws nd{p.nee_keys, did};
  const LightPoint lp = light_point(nd, sc);
  const V3 stl = sub(lp.p, e.pos);
  const float d2 = fmaxf(length_sq(stl), kRayEps);
  const float dist = sqrtf(d2);
  const V3 stl_u = v3(stl.x / dist, stl.y / dist, stl.z / dist);
  const float cos_light = dot(lp.n, neg(stl_u));
  if (!(cos_light >= kEps)) return;
  const V3 origin = add(e.pos, scale(e.n, kRayEps));
  ++rays;
  const Trace8 sh = trace8<true>(sc.table, sc.tri_f32, sc.tri_cols, origin.x,
                                 origin.y, origin.z, stl_u.x, stl_u.y,
                                 stl_u.z, dist - kEps, lp.tri, true);
  rows += sh.rows;
  if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f)) return;
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float cos_surf = fabsf(dot(e.n, stl_u));
  const float g = fminf(cos_light * cos_surf / d2, kMaxGNee);
  const float pdf_connect = (1.0f / num) / fmaxf(lp.area, 1e-20f);
  const float pdf_emit_sa = cos_light / kPi;
  const V3 stl_local = to_local(stl_u, e.n);
  const V3 to_prev_loc = to_local(e.to_prev, e.n);
  const V3 f = bsdf_f(e.m, e.albedo, to_prev_loc, stl_local, 1.0f, e.trans);
  const V3 contrib = scale(mul(f, lp.le), g / pdf_connect);
  const float pdf_bsdf_sa =
      bsdf_pdf(e.m, to_prev_loc, stl_local, 1.0f, e.trans);
  const float pdf_bsdf_area = pdf_bsdf_sa * fabsf(cos_light) / d2;
  const float ratio = pdf_bsdf_area / fmaxf(pdf_connect, 1e-20f);
  const float w_light = p.flavor == kFlavorBdpt ? ratio : ratio * ratio;
  const float pdf_curr_rev_area = pdf_emit_sa * fabsf(stl_local.z) / d2;
  const float pdf_prev_rev_sa =
      bsdf_pdf(e.m, stl_local, to_prev_loc, 1.0f, e.trans);
  const float w_eye =
      pdf_curr_rev_area * (p.eta_vcm + e.d_vcm + pdf_prev_rev_sa * e.d_vc);
  const float weight = 1.0f / (1.0f + w_light + w_eye);
  li = add(li, resolve(p, p.weighting(mul(contrib, e.thr), weight), sh));
}

// The merge at eye vertex e (shade-time normal): its slots' sum from zero;
// adds the cap's dropped photons.
__device__ __forceinline__ V3 merge_mega(const MegaParams& p,
                                         const GridRefs& g,
                                         const EyeVertex& e,
                                         int32_t& dropped) {
  const V3 prev_loc = to_local(e.to_prev, e.n);
  const float eta = fmaxf(p.eta_vcm, 1e-30f);
  V3 li_m = v3(0.0f, 0.0f, 0.0f);
  auto term = [&](const Photon& ph, float w) {
    float weight;
    const V3 base = merge_term(e, prev_loc, ph, eta, weight);
    li_m = add(li_m, p.weighting(scale(base, p.merge_norm * w), weight));
  };
  if (g.cap <= 8)
    dropped += neighbor_slots<false>(
        g, e.pos, [&](int, const float* row, bool ok, float w) {
          if (ok) term(photon_fields(row), w);
        });
  else
    dropped += fold_neighbors(g, e.pos, term);
  return li_m;
}

// The mega eye path of chunk lane l, pixel (px, py): its radiance (before
// the RGB9E5 retirement); adds its rays and BVH8 rows, its dropped photons.
__device__ __forceinline__ V3 mega_eye_pixel(const SceneRefs& sc,
                                             const MegaParams& p,
                                             const MegaIn& in, int64_t l,
                                             int32_t px, int32_t py,
                                             int32_t& rays, int32_t& rows,
                                             int32_t& dropped) {
  const bool vcm = p.flavor == kFlavorVcm;
  const uint32_t id = static_cast<uint32_t>((py << 14) + px);
  const uint32_t gid = static_cast<uint32_t>(p.gbase + l) * kMegaIdStride;
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
  V3 li = v3(0.0f, 0.0f, 0.0f);

  for (int depth = 0; depth < p.eye_depth; ++depth) {
    ++rays;
    const Trace8 h = trace8<false>(sc.table, nullptr, 0, o.x, o.y, o.z, d.x,
                                   d.y, d.z, kBigT, -1, true);
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
    const uint32_t did = gid + static_cast<uint32_t>(depth);
    const TableDraws bd{p.bsdf_keys, did};
    const Sample bs = bsdf_sample(bd, e.m, e.albedo, neg(wo_local),
                                  s.backface, 1.0f, e.trans, true);
    const float pdf_rev_sa = bsdf_pdf(e.m, bs.wo, neg(wo_local), 1.0f,
                                      e.trans);
    const bool valid = bs.pdf >= kEps;
    const MisState mv = mis_advance(
        ms, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
        1.0f / fmaxf(pdf_fwd_area, 1e-20f), 0.0f, 0.0f, vcm, p.eta_vcm);
    e.d_vcm = mv.d_vcm;
    e.d_vc = mv.d_vc;
    e.d_vm = mv.d_vm;
    e.to_prev = normalize(sub(prev_pt, e.pos));

    if (valid && !cur_delta) {
      // at shade time: s = 0, then the merge
      if (p.naive && s.light_ind >= 0 && !s.backface)
        li = add(li, vcm ? implicit_vcm(sc, wt, s.light_ind, e, prev_delta,
                                        depth)
                         : implicit_bdpt(sc, p, s.light_ind, e, prev_pt,
                                         prev_delta, depth));
      if (vcm && p.merge) li = add(li, merge_mega(p, in.grid, e, dropped));

      // then NEE and the connections, the normal toward the previous vertex
      EyeVertex ec = e;
      if (dot(e.n, e.to_prev) < 0.0f) ec.n = neg(e.n);
      if (p.nee && sc.lights.count > 0) nee_mega(sc, p, ec, did, li, rays, rows);
      if (p.connection)
        for (int j = 0; j < p.light_rows; ++j) {
          const Vertex lv = load_vertex(in.light, j, l);
          ConnRay c;
          if (!conn_ray<kEngineBvh8>(sc, ec, lv, c, rays, rows)) continue;
          if (!(max3(c.sh.s0, c.sh.s1, c.sh.s2) > 0.0f)) continue;
          float weight;
          const V3 base = conn_terms(sc, p.eta_vcm, ec, lv, c, weight);
          li = add(li, resolve(p, wt(base, weight), c.sh));
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
  return li;
}

// ---- host side: the C entry's argument block -------------------------------

struct MegaLaunch {
  SceneRefs sc;
  MegaParams p;
  MegaIn in;
  const int32_t* px;   // [c_pix] the chunk's pixels
  const int32_t* py;
  float* out;          // [P,3] the frame: lane l writes row gbase + l
  int32_t* rays;       // [c_pix] +=
  int32_t* dropped;    // [c_pix] =
  int32_t* rows;       // [c_pix] += or null
  int64_t n;           // the chunk's live pixels (threads)
};

// Layouts at the entry in mega_eye.cu.
inline bool mega_launch(const int64_t* ptrs, const int64_t* iv,
                        const float* fv, const uint32_t* keys,
                        MegaLaunch& c) {
  c.n = iv[0];
  const int64_t n_buf = iv[1];
  c.sc.table = dev_ptr<const float>(ptrs, 0);
  c.sc.tri_f32 = dev_ptr<const float>(ptrs, 1);
  c.sc.tri_cols = static_cast<int>(iv[2]);
  c.sc.lights.rows = dev_ptr<const float>(ptrs, 2);
  c.sc.lights.count = static_cast<int32_t>(iv[3]);
  c.sc.mat_f32 = dev_ptr<const float>(ptrs, 3);
  c.sc.textures = dev_ptr<const float>(ptrs, 4);
  c.sc.nodes = nullptr;  // K14 traces BVH8 on every scene
  c.sc.node_w = c.sc.leaf_k = 0;
  c.px = dev_ptr<const int32_t>(ptrs, 5);
  c.py = dev_ptr<const int32_t>(ptrs, 6);
  MegaParams& p = c.p;
  p.cam = make_camera(fv, keys);
  p.plane_area = fv[19];
  p.eta_vcm = fv[20];
  p.merge_norm = fv[21];
  for (int k = 0; k < 8; ++k) p.bsdf_keys[k] = keys[8 + k];
  for (int k = 0; k < 6; ++k) p.nee_keys[k] = keys[16 + k];
  p.eye_depth = static_cast<int>(iv[4]);
  p.light_rows = static_cast<int>(iv[5]);
  p.flavor = static_cast<int>(iv[6]);
  p.naive = iv[7] != 0;
  p.nee = iv[8] != 0;
  p.connection = iv[9] != 0;
  p.weighting.do_mis = iv[10] != 0;
  p.weighting.paint_weight = iv[11] != 0;
  p.sample_environment = iv[12] != 0;
  p.merge = iv[13] != 0;
  p.sppm = iv[14] != 0;
  p.gbase = iv[20];
  c.in.light = path_bufs(ptrs + 7, n_buf, p.light_rows);
  GridRefs& g = c.in.grid;
  g.rows = dev_ptr<const float>(ptrs, 18);
  g.cell_se = dev_ptr<const int32_t>(ptrs, 19);
  g.geom.table_size = static_cast<uint32_t>(iv[15]);
  g.cap = static_cast<int>(iv[16]);
  g.one_brick = iv[17] != 0;
  g.reweight = iv[18] != 0;
  g.n_rows = iv[19];
  for (int k = 0; k < 3; ++k) g.geom.smin[k] = fv[22 + k];
  g.geom.cell_size = fv[25];
  g.r2 = fv[26];
  c.out = dev_ptr<float>(ptrs, 20);
  c.rays = dev_ptr<int32_t>(ptrs, 21);
  c.dropped = dev_ptr<int32_t>(ptrs, 22);
  c.rows = dev_ptr<int32_t>(ptrs, 23);
  const bool merge = p.flavor == kFlavorVcm && p.merge;
  const bool grid_ok =
      !merge || (g.rows != nullptr && g.cell_se != nullptr &&
                 g.geom.table_size > 0 && g.cap >= 1 && g.n_rows >= 16 &&
                 g.n_rows % 8 == 0);
  return p.eye_depth >= 1 && p.light_rows >= 0 && c.n <= n_buf &&
         (p.flavor == kFlavorVcm || p.flavor == kFlavorBdpt) && grid_ok;
}

// One pixel of the mega eye pass, as the kernel runs it.
__device__ __forceinline__ void mega_eye_one(const MegaLaunch& c, int64_t l) {
  int32_t r = 0, w = 0, dr = 0;
  const V3 li = mega_eye_pixel(c.sc, c.p, c.in, l, c.px[l], c.py[l], r, w, dr);
  put3(c.out, c.p.gbase + l, round_rgb9e5(li));
  c.rays[l] += r;
  c.dropped[l] = dr;
  if (c.rows != nullptr) c.rows[l] += w;
}

}  // namespace tpt
