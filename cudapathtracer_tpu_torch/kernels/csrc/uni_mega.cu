// K5: the unidirectional path tracer as one per-path megakernel (NEE +
// power-2 MIS, nested dielectrics, Beer-Lambert absorption, Russian
// roulette), for both engines, and the naive integrator (schedule naive).
//
// Replaces cudapathtracer_tpu/models/unidirectional_mega.py:render_sample
// (line 222) and serves the classic engine too
// (models/unidirectional.py:render_sample): the two are one estimator and
// differ only in their draw schedule. The JAX mega engine is a persistent
// lane machine (a refill queue, mini/full transitions, retirement slots,
// lane-major [3,N] state) that keeps TPU lanes busy in lockstep; none of
// that is ported. Its image does not depend on the lane schedule, because
// every draw is keyed by the path's pixel index and event counter, so here
// one thread owns one pixel's path and runs it in program order:
//   raygen (K7) -> closest hit (K1) -> miss: sky | shade (K2) -> Beer and
//   the priority/false-hit logic -> emission with the MIS counter-weight ->
//   NEE sample (K4) and its shadow ray (K1) -> BSDF sample (K3) -> medium
//   stack push/remove on refraction -> Russian roulette past max_depth + 1,
// until a miss, a kill, depth 100 or the event cap.
//
// Schedules (draw d of the closest event `lit` of the path at list index
// p, pixel (px, py)):
//   classic: key fold_in(fold_in(skey, lit), d), id (py << 14) + px; at
//            most 132 events (the classic loop bound HARD_DEPTH_CAP + 32);
//            rays = closest events + NEE candidates (do_nee);
//   mega:    key fold_in(skey, d), id p * 191 + lit; at most 133 events
//            (the lane dies after the event with lit >= LIT_CAP = 132);
//            rays = closest events + traced NEE shadows; each path's
//            radiance retires through RGB9E5 (K10, packing.cuh), as the
//            JAX engine's retirement slots hold it;
//   naive:   models/naive.py:render_sample (line 41): render_naive_path.
// The classic per-event key is derived here with tpt::threefry2x32, so no
// key table is needed. The NEE weight is summed in each schedule's order:
// classic (beta * (contrib * shadow)) * w; mega ((beta * contrib) * w) *
// shadow, the JAX engine's pending-then-scale.
//
// Bound: memory latency of the traversal (K1: dependent row reads, rays
// diverge), then of the shading row and light row reads; the BSDF and NEE
// arithmetic is a few hundred flops per event. One launch per sample ends
// with the longest paths (up to 133 events), so the tail of a launch runs
// few threads; that is the first thing to measure.
// Design: all path state (beta, li, the 16-entry medium stack, the
// 16-entry BVH stack inside K1) lives in registers and local memory; each
// event reads its own rows, and the only writes are li and the path's ray
// count at the end. Built with -fmad=false and correctly rounded sqrtf and
// division, so the arithmetic follows the plain PyTorch version.
//
// The k-sample mode (uni_mega_batch_kernel) replaces
// cudapathtracer_tpu/models/batch.py:make_batched (line 33) for these
// three schedules: the JAX fori_loop over k samples in one dispatch becomes
// a loop over the batch's samples inside each thread, with each sample's
// key words read from a [k, 28] table in device memory, so a batch is one
// launch and one write of the pixel's sum. It does the work of k single
// launches, so its bound is k times theirs.
//
// Engines: every kernel here is a template on the traversal engine
// (traverse_bin.cuh): kEngineBvh8 traces with K1 (bvh8_table),
// kEngineThreaded with K15 (node_packed), as the JAX classic and naive
// integrators follow the scene's traversal. The mega schedule traces BVH8
// on every scene (the JAX mega engine's make_fused_step reads the BVH8
// table), so its launches take the BVH8 instantiation; the C entries pick
// the instantiation from their engine argument.

#include <cuda_runtime.h>

#include <cstdint>

#include "bsdf.cuh"
#include "camera.cuh"
#include "nee.cuh"
#include "packing.cuh"
#include "shade.cuh"
#include "threefry.cuh"
#include "traverse_bin.cuh"

namespace tpt {

constexpr int kHardDepthCap = 100;
constexpr int kLitCap = kHardDepthCap + 32;
constexpr int kIdStride = 191;
constexpr int kDNee = 0;
constexpr int kDBsdf = 4;
constexpr int kDRr = 8;
constexpr int kScheduleClassic = 0;
constexpr int kScheduleMega = 1;
constexpr int kScheduleNaive = 2;   // the naive integrator (no NEE/MIS/RR)
constexpr int kShadeEvalCols = 38;

struct SceneArgs {
  const float* table;      // bvh8_table [R, 96]
  const float* tri_f32;    // [T, tri_cols]
  int tri_cols;
  Lights lights;           // light_f32 [L, 17]
  const float* textures;   // [A, 3]
  const float* medium;     // [M, 4]: absorption xyz, ior
  const float* nodes;      // node_packed [M, node_w] (threaded engine)
  int node_w, leaf_k;
};

struct Params {
  CameraParams cam;
  uint32_t skey0, skey1;
  uint32_t draw_keys[18];  // mega: draw_key(skey, d), d = 0..8
  int max_depth;
  int use_mis;
  int sample_environment;
  int schedule;
  int32_t air_priority;
};

// The draws of one closest event: draw(d) -> uniform.
struct EventDraws {
  const uint32_t* mega_keys;
  uint32_t b0, b1;  // classic: the event's bounce key
  uint32_t id;
  bool classic;

  __device__ __forceinline__ float operator()(int d) const {
    if (classic) {
      uint32_t k0 = 0u, k1 = static_cast<uint32_t>(d);
      threefry2x32(b0, b1, k0, k1);  // fold_in(bounce key, d)
      return uniform_draw_key(k0, k1, id);
    }
    return uniform_draw_key(mega_keys[2 * d], mega_keys[2 * d + 1], id);
  }
};

// draw(k) of a lobe or of NEE: the event's draw base + k.
struct BasedDraws {
  const EventDraws* e;
  int base;
  __device__ __forceinline__ float operator()(int k) const {
    return (*e)(base + k);
  }
};

struct PathOut {
  V3 li;
  int32_t rays, rows;  // rays traced, rows (BVH8 or nodes) they visited
};

// One path from its primary ray (o, d); index: the path's position in the
// pixel list (mega ids), pix_id: its pixel id (classic ids).
template <int kEngine>
__device__ __forceinline__ PathOut render_path(const SceneArgs& sc,
                                               const Params& p,
                                               int64_t index, uint32_t pix_id,
                                               V3 o, V3 d) {
  const bool classic = p.schedule == kScheduleClassic;
  const float num_lights =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  V3 beta = v3(1.0f, 1.0f, 1.0f), li = v3(0.0f, 0.0f, 0.0f);
  V3 prev_point = v3(0.0f, 0.0f, 0.0f);
  float prev_pdf = kEps, eta_i = kEps;
  int depth = 0;
  bool hit_nonspec = false;
  MediumStack ms;
  ms.init(p.air_priority);
  int32_t rays = 0, rows = 0;
  const int events = classic ? kLitCap : kLitCap + 1;

  for (int lit = 0; lit < events; ++lit) {
    ++rays;
    EventDraws e;
    e.mega_keys = p.draw_keys;
    e.classic = classic;
    if (classic) {
      e.b0 = 0u;
      e.b1 = static_cast<uint32_t>(lit);
      threefry2x32(p.skey0, p.skey1, e.b0, e.b1);  // fold_in(skey, lit)
      e.id = pix_id;
    } else {
      e.b0 = e.b1 = 0u;
      e.id = static_cast<uint32_t>(index * kIdStride + lit);
    }

    const Trace8 h = trace_ray<kEngine, false>(sc, o.x, o.y, o.z, d.x, d.y,
                                               d.z, kBigT, -1, true);
    rows += h.rows;
    if (h.tri < 0) {
      li = add(li, mul(beta, sample_sky(d, p.sample_environment != 0)));
      break;
    }
    const ShadeHit s =
        shade_fetch(sc.tri_f32, sc.tri_cols, h.tri, h.u, h.v, o, d, h.t);
    const Mat& m = s.mat;
    const V3 wi_local = to_local(d, s.normal);
    const V3 albedo = resolve_albedo(sc.textures, s);
    const float trans = resolve_transmission(sc.textures, s);

    // dominant medium + Beer-Lambert absorption
    const int32_t dom = ms.dominant();
    const int32_t dom_id = dom & 1023, dom_pri = dom >> 10;
    const float* med = sc.medium + 4 * dom_id;
    if (h.t > kEps) {
      beta = v3(beta.x * expf(-__ldg(med) * h.t),
                beta.y * expf(-__ldg(med + 1) * h.t),
                beta.z * expf(-__ldg(med + 2) * h.t));
    }
    // a lower-priority boundary crossed inside a dominant medium is a
    // false hit: the path passes straight through
    const bool true_hit = !(m.boundary && m.priority > dom_pri);
    const float dom_ior = __ldg(med + 3);
    if ((true_hit && m.boundary && m.type == kMatSmoothDielectric) ||
        !m.boundary)
      eta_i = dom_ior;
    if (!true_hit) {
      if (!s.backface)
        ms.push(s.mat_id, m.priority);
      else
        ms.remove(s.mat_id);
    }

    // emission
    const bool emissive = length_sq(s.emission) > kEps;
    const bool direct_view = depth == 0 || !hit_nonspec;
    if (true_hit && emissive && direct_view)
      li = add(li, mul(beta, s.emission));

    if (p.use_mis) {
      // a BSDF-sampled ray hit a light: weigh against the NEE pdf
      if (true_hit && emissive && !direct_view && !m.is_specular) {
        const float lpdf =
            nee_pdf(prev_point, s.point, s.normal_a, s.area, num_lights);
        if (lpdf > kEps)
          li = add(li, scale(mul(beta, s.emission),
                             power2_weight(prev_pdf, lpdf)));
      }
      // NEE from non-emissive, non-specular surfaces
      const bool do_nee = true_hit && !emissive && !m.is_specular;
      if (classic && do_nee) ++rays;
      if (do_nee && sc.lights.count > 0) {
        const BasedDraws nd{&e, kDNee};
        const NeeSample ns = nee_sample(nd, sc.lights, s.point, s.normal,
                                        wi_local, m, albedo, eta_i, true,
                                        trans);
        if (ns.active) {
          if (!classic) ++rays;
          const float bpdf =
              bsdf_pdf(m, neg(wi_local), ns.wo_local, eta_i, trans);
          const float w = power2_weight(ns.light_pdf, bpdf);
          const Trace8 sh = trace_ray<kEngine, true>(
              sc, ns.origin.x, ns.origin.y, ns.origin.z, ns.dir.x, ns.dir.y,
              ns.dir.z, ns.max_t, -1, true);
          rows += sh.rows;
          const V3 shadow = v3(sh.s0, sh.s1, sh.s2);
          if (classic) {
            if (fmaxf(fmaxf(sh.s0, sh.s1), sh.s2) > 0.0f)
              li = add(li, scale(mul(beta, mul(ns.contrib, shadow)), w));
          } else {
            li = add(li, mul(scale(mul(beta, ns.contrib), w), shadow));
          }
        }
      }
    }

    // BSDF sampling
    const BasedDraws bd{&e, kDBsdf};
    const Sample bs =
        bsdf_sample(bd, m, albedo, neg(wi_local), s.backface, eta_i, trans);
    const float pdf = fmaxf(bs.pdf, 0.01f);
    if (true_hit) {
      // medium stack push/pop on refraction through a true-hit boundary
      if (bs.wo.z < 0.0f) {
        if (!s.backface)
          ms.push(s.mat_id, m.priority);
        else
          ms.remove(s.mat_id);
      }
      beta = scale(mul(beta, bs.f), fabsf(bs.wo.z) / pdf);
      const float side = bs.wo.z > 0.0f ? 1.0f : -1.0f;
      o = add(s.point, scale(s.normal, side * kEps));
      d = normalize(to_world(bs.wo, s.normal));
      prev_pdf = pdf;
      prev_point = s.point;
      ++depth;
    } else {
      o = add(s.point, scale(d, kRayEps));  // pass straight through
    }

    // Russian roulette past max_depth
    if (depth > p.max_depth + 1) {
      const float p_surv = fminf(fmaxf(luminance(beta), 0.05f), 0.99f);
      if (e(kDRr) > p_surv) break;
      beta = v3(beta.x / p_surv, beta.y / p_surv, beta.z / p_surv);
    }
    if (depth >= kHardDepthCap) break;
    hit_nonspec = hit_nonspec || !m.is_specular;
  }
  PathOut out;
  out.li = li;
  out.rays = rays;
  out.rows = rows;
  return out;
}

// The naive integrator's path (models/naive.py): BSDF sampling only, no
// NEE, MIS or Russian roulette, eta_i = 1, emission added after the
// sampling-validity break, at most max_depth bounces; bounce `depth` draws
// keyed by fold_in(fold_in(skey, depth), d) with the pixel id; the next ray
// is unnormalized to_world(wo) from the side of wo.z.
template <int kEngine>
__device__ __forceinline__ PathOut render_naive_path(const SceneArgs& sc,
                                                     const Params& p,
                                                     uint32_t pix_id, V3 o,
                                                     V3 d) {
  V3 beta = v3(1.0f, 1.0f, 1.0f), li = v3(0.0f, 0.0f, 0.0f);
  int32_t rays = 0, rows = 0;
  for (int depth = 0; depth < p.max_depth; ++depth) {
    ++rays;
    EventDraws e;
    e.mega_keys = p.draw_keys;
    e.classic = true;
    e.b0 = 0u;
    e.b1 = static_cast<uint32_t>(depth);
    threefry2x32(p.skey0, p.skey1, e.b0, e.b1);  // bounce_key(skey, depth)
    e.id = pix_id;
    const Trace8 h = trace_ray<kEngine, false>(sc, o.x, o.y, o.z, d.x, d.y,
                                               d.z, kBigT, -1, true);
    rows += h.rows;
    if (h.tri < 0) {
      li = add(li, mul(beta, sample_sky(d, p.sample_environment != 0)));
      break;
    }
    const ShadeHit s =
        shade_fetch(sc.tri_f32, sc.tri_cols, h.tri, h.u, h.v, o, d, h.t);
    const V3 wi_local = to_local(d, s.normal);
    const V3 albedo = resolve_albedo(sc.textures, s);
    const float trans = resolve_transmission(sc.textures, s);
    const BasedDraws bd{&e, 0};
    const Sample bs =
        bsdf_sample(bd, s.mat, albedo, neg(wi_local), s.backface, 1.0f, trans);
    if (bs.pdf <= 0.0f || length_sq(bs.f) < kEps) break;
    li = add(li, mul(s.emission, beta));
    beta = scale(mul(beta, bs.f), fabsf(bs.wo.z) / fmaxf(bs.pdf, 1e-20f));
    d = to_world(bs.wo, s.normal);
    const float side = bs.wo.z > 0.0f ? 1.0f : -1.0f;
    o = add(s.point, scale(s.normal, side * kRayEps));
  }
  PathOut out;
  out.li = li;
  out.rays = rays;
  out.rows = rows;
  return out;
}

// What the plain K2-K4 functions return for one hit (shade_eval): point,
// normal, uv, backface, albedo, transmission, then NEE (contrib, light_pdf,
// wo_local, shadow origin, dir, max_t, active), the NEE direction's BSDF
// pdf, the BSDF sample (wo, f, pdf), mat_id and emissive. Draws use the
// mega keys with id ids[i]; NEE is active on hits that are neither
// emissive nor specular.
__device__ __forceinline__ void shade_eval_one(const SceneArgs& sc,
                                               const Params& p, V3 o, V3 d,
                                               float t, int32_t tri, float u,
                                               float v, uint32_t id,
                                               float eta_i, float* out) {
  const ShadeHit s = shade_fetch(sc.tri_f32, sc.tri_cols, tri, u, v, o, d, t);
  const Mat& m = s.mat;
  const V3 wi_local = to_local(d, s.normal);
  const V3 albedo = resolve_albedo(sc.textures, s);
  const float trans = resolve_transmission(sc.textures, s);
  const bool emissive = length_sq(s.emission) > kEps;
  EventDraws e;
  e.mega_keys = p.draw_keys;
  e.classic = false;
  e.b0 = e.b1 = 0u;
  e.id = id;
  NeeSample ns;
  if (sc.lights.count > 0) {
    const BasedDraws nd{&e, kDNee};
    ns = nee_sample(nd, sc.lights, s.point, s.normal, wi_local, m, albedo,
                    eta_i, tri >= 0 && !emissive && !m.is_specular, trans);
  } else {
    ns.contrib = ns.wo_local = ns.dir = v3(0.0f, 0.0f, 0.0f);
    ns.light_pdf = -1.0f;
    ns.origin = s.point;
    ns.max_t = 0.0f;
    ns.active = false;
  }
  const float bpdf = bsdf_pdf(m, neg(wi_local), ns.wo_local, eta_i, trans);
  const BasedDraws bd{&e, kDBsdf};
  const Sample bs =
      bsdf_sample(bd, m, albedo, neg(wi_local), s.backface, eta_i, trans);
  const V3 cols[] = {s.point, s.normal};
  int c = 0;
  for (const V3& x : cols) {
    out[c++] = x.x;
    out[c++] = x.y;
    out[c++] = x.z;
  }
  out[c++] = s.uv0;
  out[c++] = s.uv1;
  out[c++] = s.backface ? 1.0f : 0.0f;
  out[c++] = albedo.x;
  out[c++] = albedo.y;
  out[c++] = albedo.z;
  out[c++] = trans;
  const V3 nee_cols[] = {ns.contrib};
  for (const V3& x : nee_cols) {
    out[c++] = x.x;
    out[c++] = x.y;
    out[c++] = x.z;
  }
  out[c++] = ns.light_pdf;
  const V3 ray_cols[] = {ns.wo_local, ns.origin, ns.dir};
  for (const V3& x : ray_cols) {
    out[c++] = x.x;
    out[c++] = x.y;
    out[c++] = x.z;
  }
  out[c++] = ns.max_t;
  out[c++] = ns.active ? 1.0f : 0.0f;
  out[c++] = bpdf;
  const V3 bs_cols[] = {bs.wo, bs.f};
  for (const V3& x : bs_cols) {
    out[c++] = x.x;
    out[c++] = x.y;
    out[c++] = x.z;
  }
  out[c++] = bs.pdf;
  out[c++] = static_cast<float>(s.mat_id);
  out[c++] = emissive ? 1.0f : 0.0f;
}

}  // namespace tpt

// ---- kernels and their C entry points --------------------------------------

namespace {

constexpr int kThreads = 128;

// One sample of the path of pixel (x, y) at list index i: raygen, the
// schedule's path, and the mega engine's RGB9E5 retirement.
template <int kEngine>
__device__ __forceinline__ tpt::PathOut sample_pixel(const tpt::SceneArgs& sc,
                                                     const tpt::Params& p,
                                                     int64_t i, int32_t x,
                                                     int32_t y) {
  const uint32_t pix_id = static_cast<uint32_t>((y << 14) + x);
  float org[3], dir[3];
  tpt::camera_ray(p.cam, static_cast<float>(x), static_cast<float>(y), pix_id,
                  org, dir);
  const tpt::V3 o = tpt::v3(org[0], org[1], org[2]);
  const tpt::V3 d = tpt::v3(dir[0], dir[1], dir[2]);
  tpt::PathOut r = p.schedule == tpt::kScheduleNaive
                       ? tpt::render_naive_path<kEngine>(sc, p, pix_id, o, d)
                       : tpt::render_path<kEngine>(sc, p, i, pix_id, o, d);
  // the mega engine retires each path's radiance through RGB9E5
  if (p.schedule == tpt::kScheduleMega) r.li = tpt::round_rgb9e5(r.li);
  return r;
}

template <int kEngine>
__global__ void __launch_bounds__(kThreads)
uni_mega_kernel(tpt::SceneArgs sc, tpt::Params p,
                const int32_t* __restrict__ px,
                const int32_t* __restrict__ py, int64_t n,
                float* __restrict__ li_out, int32_t* __restrict__ rays_out,
                int32_t* __restrict__ rows_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const tpt::PathOut r = sample_pixel<kEngine>(sc, p, i, px[i], py[i]);
  li_out[3 * i] = r.li.x;
  li_out[3 * i + 1] = r.li.y;
  li_out[3 * i + 2] = r.li.z;
  rays_out[i] = r.rays;
  if (rows_out != nullptr) rows_out[i] = r.rows;
}

// The k-sample mode (models/batch.py:make_batched): sample s of the batch
// takes row s of keys [k, 28] (the words tpt_render_unidirectional takes
// by value, uploaded once per batch); each sample's radiance, retired as in
// one launch, is added into a float32 accumulator that starts at 0, in
// sample order, which is the JAX fori_loop's sum, and the rays into the
// pixel's int32 counter. li_out and rays_out are written once.
template <int kEngine>
__global__ void __launch_bounds__(kThreads)
uni_mega_batch_kernel(tpt::SceneArgs sc, tpt::Params p,
                      const uint32_t* __restrict__ keys, int32_t k,
                      const int32_t* __restrict__ px,
                      const int32_t* __restrict__ py, int64_t n,
                      float* __restrict__ li_out,
                      int32_t* __restrict__ rays_out,
                      int32_t* __restrict__ rows_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int32_t x = px[i], y = py[i];
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  int32_t rays = 0, rows = 0;
  for (int32_t s = 0; s < k; ++s) {
    const uint32_t* row = keys + 28 * static_cast<int64_t>(s);
    tpt::Params ps = p;
    for (int w = 0; w < 8; ++w) ps.cam.keys[w] = row[w];
    ps.skey0 = row[8];
    ps.skey1 = row[9];
    for (int w = 0; w < 18; ++w) ps.draw_keys[w] = row[10 + w];
    const tpt::PathOut r = sample_pixel<kEngine>(sc, ps, i, x, y);
    ax = ax + r.li.x;
    ay = ay + r.li.y;
    az = az + r.li.z;
    rays += r.rays;
    rows += r.rows;
  }
  li_out[3 * i] = ax;
  li_out[3 * i + 1] = ay;
  li_out[3 * i + 2] = az;
  rays_out[i] = rays;
  if (rows_out != nullptr) rows_out[i] = rows;
}

__global__ void __launch_bounds__(kThreads)
shade_eval_kernel(tpt::SceneArgs sc, tpt::Params p,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t, const int32_t* __restrict__ tri,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const int32_t* __restrict__ ids,
                  const float* __restrict__ eta_i, int64_t n,
                  float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  tpt::shade_eval_one(
      sc, p, tpt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]),
      tpt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]), t[i], tri[i], u[i], v[i],
      static_cast<uint32_t>(ids[i]), eta_i[i],
      out + tpt::kShadeEvalCols * i);
}

// scene: the table pointers (nodes: the threaded engine's, or null);
// cam_params: 19 floats and keys: 8 camera key words, the sample key pair
// and 18 mega draw-key words (host memory).
tpt::SceneArgs make_scene(const float* table, const float* tri_f32,
                          int32_t tri_cols, const float* light_f32,
                          int32_t num_lights, const float* textures,
                          const float* medium, const float* nodes = nullptr,
                          int32_t node_w = 0, int32_t leaf_k = 0) {
  tpt::SceneArgs sc;
  sc.table = table;
  sc.nodes = nodes;
  sc.node_w = node_w;
  sc.leaf_k = leaf_k;
  sc.tri_f32 = tri_f32;
  sc.tri_cols = tri_cols;
  sc.lights.rows = light_f32;
  sc.lights.count = num_lights;
  sc.textures = textures;
  sc.medium = medium;
  return sc;
}

tpt::Params make_params(const float* cam_params, const uint32_t* keys,
                        int32_t max_depth, int32_t use_mis,
                        int32_t sample_environment, int32_t schedule,
                        int32_t air_priority) {
  tpt::Params p;
  p.cam = tpt::make_camera(cam_params, keys);
  p.skey0 = keys[8];
  p.skey1 = keys[9];
  for (int k = 0; k < 18; ++k) p.draw_keys[k] = keys[10 + k];
  p.max_depth = max_depth;
  p.use_mis = use_mis;
  p.sample_environment = sample_environment;
  p.schedule = schedule;
  p.air_priority = air_priority;
  return p;
}

bool schedule_ok(int32_t schedule) {
  return schedule == tpt::kScheduleClassic ||
         schedule == tpt::kScheduleMega || schedule == tpt::kScheduleNaive;
}

}  // namespace

// One sample of n paths: li [n,3] f32 and each path's ray count [n] i32;
// rows may be null, else each path's count of rows visited (BVH8 rows or
// threaded nodes). engine: kEngineBvh8 (0) or kEngineThreaded (1, with
// nodes [M, node_w] and leaf_k). Returns the launch's cudaError_t.
extern "C" int tpt_render_unidirectional(
    const float* table, const float* tri_f32, int32_t tri_cols,
    const float* light_f32, int32_t num_lights, const float* textures,
    const float* medium, const int32_t* px, const int32_t* py, int64_t n,
    const float* cam_params, const uint32_t* keys, int32_t max_depth,
    int32_t use_mis, int32_t sample_environment, int32_t schedule,
    int32_t air_priority, int32_t engine, const float* nodes, int32_t node_w,
    int32_t leaf_k, float* li, int32_t* rays, int32_t* rows, void* stream) {
  if (!schedule_ok(schedule) ||
      !tpt::engine_ok(engine, nodes, node_w, leaf_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const tpt::SceneArgs sc =
      make_scene(table, tri_f32, tri_cols, light_f32, num_lights, textures,
                 medium, nodes, node_w, leaf_k);
  const tpt::Params p = make_params(cam_params, keys, max_depth, use_mis,
                                    sample_environment, schedule,
                                    air_priority);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (engine == tpt::kEngineThreaded)
    uni_mega_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(
        sc, p, px, py, n, li, rays, rows);
  else
    uni_mega_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(
        sc, p, px, py, n, li, rays, rows);
  return static_cast<int>(cudaGetLastError());
}

// The k-sample mode: k samples of n paths summed; keys [k, 28] (device
// memory) holds each sample's words, row s in the layout of `keys` above.
// li [n,3] is the sum of the k samples' radiance, rays [n] of their rays.
// Returns the launch's cudaError_t.
extern "C" int tpt_render_unidirectional_batch(
    const float* table, const float* tri_f32, int32_t tri_cols,
    const float* light_f32, int32_t num_lights, const float* textures,
    const float* medium, const int32_t* px, const int32_t* py, int64_t n,
    const float* cam_params, const uint32_t* keys, int32_t k,
    int32_t max_depth, int32_t use_mis, int32_t sample_environment,
    int32_t schedule, int32_t air_priority, int32_t engine,
    const float* nodes, int32_t node_w, int32_t leaf_k, float* li,
    int32_t* rays, int32_t* rows, void* stream) {
  if (k < 1 || keys == nullptr || !schedule_ok(schedule) ||
      !tpt::engine_ok(engine, nodes, node_w, leaf_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  static const uint32_t kNoKeys[28] = {};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const tpt::SceneArgs sc =
      make_scene(table, tri_f32, tri_cols, light_f32, num_lights, textures,
                 medium, nodes, node_w, leaf_k);
  const tpt::Params p = make_params(cam_params, kNoKeys, max_depth, use_mis,
                                    sample_environment, schedule,
                                    air_priority);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (engine == tpt::kEngineThreaded)
    uni_mega_batch_kernel<tpt::kEngineThreaded><<<blocks, kThreads, 0, st>>>(
        sc, p, keys, k, px, py, n, li, rays, rows);
  else
    uni_mega_batch_kernel<tpt::kEngineBvh8><<<blocks, kThreads, 0, st>>>(
        sc, p, keys, k, px, py, n, li, rays, rows);
  return static_cast<int>(cudaGetLastError());
}

// Test entry: the K2-K4 device functions once per hit; out [n, 38] f32
// (columns: shade_eval_one). Returns the launch's cudaError_t.
extern "C" int tpt_shade_eval(
    const float* tri_f32, int32_t tri_cols, const float* light_f32,
    int32_t num_lights, const float* textures, const float* medium,
    const float* o, const float* d, const float* t, const int32_t* tri,
    const float* u, const float* v, const int32_t* ids, const float* eta_i,
    int64_t n, const uint32_t* keys, float* out, void* stream) {
  if (n <= 0) return 0;
  static const float kNoCamera[19] = {};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  shade_eval_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_scene(nullptr, tri_f32, tri_cols, light_f32, num_lights, textures,
                 medium),
      make_params(kNoCamera, keys, 0, 1, 0, tpt::kScheduleMega, 0), o, d, t,
      tri, u, v, ids, eta_i, n, out);
  return static_cast<int>(cudaGetLastError());
}
