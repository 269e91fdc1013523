// K5: the unidirectional path tracer as one persistent megakernel (NEE +
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
// every draw is keyed by the path's pixel index and event counter. One
// path's events run in program order:
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
//   naive:   models/naive.py:render_sample (line 41): naive_event.
// Every key a draw needs is the same for every lane at the same (sample,
// event), so none is folded in a lane: the key kernel (below) writes each
// sample's draw keys into a table (keys.cuh), the classic and naive
// schedules' [k][rows][9] pairs draw_key(bounce_key(skey, lit), d) (rows:
// 132 classic, every event a path can take, max_depth naive) and the mega
// schedule's [k][9] pairs draw_key(skey, d), and a draw is one 8-byte load
// and one cipher on the lane's id (the classic event folded its bounce key
// and each draw's pair before: 1 + 2 x draws ciphers). The NEE weight is
// summed in each schedule's order: classic (beta * (contrib * shadow)) *
// w; mega ((beta * contrib) * w) * shadow, the JAX engine's
// pending-then-scale.
//
// Samples: one launch renders k >= 1 samples of every pixel and also replaces
// cudapathtracer_tpu/models/batch.py:make_batched (line 33) for these three
// schedules: samples s0 .. s0+k-1 under the base key. A small kernel launched
// first on the stream derives each sample's keys (as
// models/unidirectional.render_plain folds them) with Threefry: its camera draw
// keys into a [k, 8] table in device scratch, its draw keys into the table
// after it, and zeroes the pixel counter beside them, so a launch takes no key
// words or memset from the host; sample s reads row s of each. (Derived inside
// K5 at each sample's start instead, the sample's Threefry calls ran in the
// divergent retire branch on most loop trips while the warp's other lanes
// waited: a 1080p mega sample took 40.1 ms against 32.0 on an H100.) The
// pixel's k radiances, each retired as above, are added into a float32 sum from
// 0 in sample order (the JAX fori_loop's sum), its rays and rows into int32
// counters; li, rays and rows are written once a pixel's k samples are done. k
// = 1 is one sample.
//
// Bound: memory latency of the traversal (K1: dependent row reads, rays
// diverge), then of the 64-byte shading record (shade.cuh), material row
// and light row reads; the BSDF and NEE arithmetic is a few hundred flops
// per event. A path takes 1 to 133
// events (mean ~5.4, p99 11 on the 1080p bunny scene at depth 8), so one
// thread per path left about half of each warp's issue slots idle while
// its longest path ran (tools/k5_lanes.py).
// Design: path regeneration on persistent threads (Novak, Havran and
// Dachsbacher, EG 2010; Aila and Laine, HPG 2009). The grid is the SMs
// times the blocks that fit on one (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor, queried once), and each thread loops one EVENT at a time
// over whichever path it holds: when the path ends it is retired, and the
// thread takes the next sample of its pixel or, after the k-th, the next
// pixel from a device counter (a warp-aggregated atomicAdd; the key
// kernel zeroes it). So the lanes of a warp stay busy with live paths
// until the pixels run out. A pixel's k
// samples run in order in one thread, and every draw is keyed by (sample,
// pixel, event), so li, rays and rows do not depend on the grid or the
// order in which pixels are taken. All path state (beta, li, the 16-entry
// medium stack, the 16-entry BVH stack inside K1) lives in registers and
// local memory; each event reads its own rows. Built with -fmad=false and
// correctly rounded sqrtf and division, so the arithmetic follows the
// plain PyTorch version. The test entry may fix the grid and count the
// events, each warp's calls of the event code and its busiest lane's
// events (the lane use and the event balance, printed by chip_smoke.py).
//
// Engines: every kernel here is a template on the traversal engine
// (traverse_bin.cuh): kEngineBvh8 traces with K1 (bvh8_table),
// kEngineThreaded with K15 (bin_table), as the JAX classic and naive
// integrators follow the scene's traversal. The mega schedule traces BVH8
// on every scene (the JAX mega engine's make_fused_step reads the BVH8
// table), so its launches take the BVH8 instantiation; the C entries pick
// the instantiation from their engine argument.

#include <cuda_runtime.h>

#include <cstdint>

#include "bsdf.cuh"
#include "camera.cuh"
#include "keys.cuh"
#include "nee.cuh"
#include "packing.cuh"
#include "persistent.cuh"
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
// A sample's camera row: the camera's 8 draw-key words.
constexpr int kKeyWords = 8;

// The camera row of sample `sample` under the base key (b0, b1), as
// models/unidirectional.render_plain folds it: skey = fold_in(base,
// sample), the camera's draw_key(fold_in(skey, 2^20), 0..3).
__device__ __forceinline__ void sample_key_row(uint32_t b0, uint32_t b1,
                                               uint32_t sample,
                                               uint32_t* row) {
  uint32_t s0, s1, c0, c1;
  fold_in(b0, b1, sample, s0, s1);
  fold_in(s0, s1, 1u << 20, c0, c1);
#pragma unroll
  for (uint32_t d = 0; d < 4; ++d)
    fold_in(c0, c1, d, row[2 * d], row[2 * d + 1]);
}

struct SceneArgs {
  const float* table;      // bvh8_table [R, 96]
  const float* tri_f32;    // [T, tri_cols] (shadow rays: MAT_LEAF rows)
  int tri_cols;
  const float4* shade;     // shade_table [T, 16] (shade.cuh)
  const float* mat_f32;    // [M, 26]
  Lights lights;           // light_f32 [L, 17]
  const float* textures;   // [A, 3]
  const float* medium;     // [M, 4]: absorption xyz, ior
  const float* bin;        // bin_table (threaded engine, traverse_bin.cuh)
  int32_t bin_nodes;       // its node records
};

// What every sample of a launch shares (the keys are per sample).
struct Params {
  CameraParams cam;
  int max_depth;
  int use_mis;
  int sample_environment;
  int schedule;
  int32_t air_priority;
};

// The draws of one closest event: draw(d) -> uniform, one cipher on the
// lane's id under pair d of the event's row of its sample's draw-key
// table: row lit (classic, naive) or the sample's one row (mega).
using EventDraws = RowDraws;

// The rows of a sample's draw-key table: every event a path of the
// schedule can take (classic, naive), or 0: one row with no bounce level
// (mega).
__host__ __device__ __forceinline__ int32_t key_rows(int32_t schedule,
                                                     int32_t max_depth) {
  return schedule == kScheduleClassic
             ? kLitCap
             : (schedule == kScheduleNaive ? max_depth : 0);
}

// The draws of a naive event: the four BSDF pairs of its row, loaded at
// once right after its closest ray, beside the shading record's loads, so
// their latency overlaps that of the hit's fetch. (Loaded at each draw, a
// naive event does little else to hide them: a 1080p naive sample took
// 0.1% and 1.8% longer in two runs of tools/rng_attribution.py, and the
// naive cell ran 1.3% below the in-lane folds the tables replaced, 0.4%
// with the loads held; H100.)
struct HeldDraws {
  KeyPair k[4];
  uint32_t id;
  __device__ __forceinline__ float operator()(int d) const {
    return uniform_draw_key(k[d].x, k[d].y, id);
  }
};

// draw(k) of a lobe or of NEE: the event's draw base + k.
template <class D>
struct BasedDraws {
  const D* e;
  int base;
  __device__ __forceinline__ float operator()(int k) const {
    return (*e)(base + k);
  }
};

// One path between two of its events.
struct PathState {
  V3 o, d;  // the next ray
  V3 beta, li, prev_point;
  float prev_pdf, eta_i;
  int depth;  // bounces taken
  int lit;    // events taken (the naive schedule: bounces)
  bool hit_nonspec;
  MediumStack ms;
};

// A new path from its primary ray (o, d), with the initial medium stack.
__device__ __forceinline__ void start_path(PathState& st, V3 o, V3 d,
                                           int32_t air_priority) {
  st.o = o;
  st.d = d;
  st.beta = v3(1.0f, 1.0f, 1.0f);
  st.li = v3(0.0f, 0.0f, 0.0f);
  st.prev_point = v3(0.0f, 0.0f, 0.0f);
  st.prev_pdf = kEps;
  st.eta_i = kEps;
  st.depth = 0;
  st.lit = 0;
  st.hit_nonspec = false;
  st.ms.init(air_priority);
}

// One event of a classic or mega path; table: its sample's draw-key
// table, index: its position in the pixel list (mega ids), pix_id: its
// pixel id (classic ids). Adds the event's rays and rows; returns whether
// the path goes on.
// Everything the event computes but NEE's shadow factor (the BSDF sample,
// the medium stack, the next ray and throughput, Russian roulette's draw)
// is done before the shadow trace, so only the NEE term's inputs and the
// path's state live across it; the NEE term joins li after the trace, in
// each schedule's order.
template <int kEngine>
__device__ __forceinline__ bool path_event(const SceneArgs& sc,
                                           const Params& p,
                                           const KeyPair* table,
                                           int64_t index, uint32_t pix_id,
                                           PathState& st, int32_t& rays,
                                           int32_t& rows) {
  const bool classic = p.schedule == kScheduleClassic;
  const float num_lights =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  V3& o = st.o;
  V3& d = st.d;
  V3& beta = st.beta;
  V3& li = st.li;
  const int lit = st.lit;
  ++rays;
  const EventDraws e =
      classic ? EventDraws{table + lit * kUniKeyDraws, pix_id}
              : EventDraws{table,
                           static_cast<uint32_t>(index * kIdStride + lit)};

  const Trace8 h = trace_ray<kEngine, false>(sc, o.x, o.y, o.z, d.x, d.y,
                                             d.z, kBigT, -1, true);
  rows += h.rows;
  if (h.tri < 0) {
    li = add(li, mul(beta, sample_sky(d, p.sample_environment != 0)));
    return false;
  }
  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, o, d, h.t);
  const Surf sm = surf(sc.mat_f32, sc.textures, s.mat_id, s.uv0, s.uv1);
  const SurfHeld m = hold(sm);
  const Frame fr = frame(s.normal);
  const V3 wi_local = to_local(d, fr);

  // dominant medium + Beer-Lambert absorption
  const int32_t dom = st.ms.dominant();
  const int32_t dom_id = dom & 1023, dom_pri = dom >> 10;
  const float* med = sc.medium + 4 * dom_id;
  if (h.t > kEps) {
    beta = v3(beta.x * expf(-__ldg(med) * h.t),
              beta.y * expf(-__ldg(med + 1) * h.t),
              beta.z * expf(-__ldg(med + 2) * h.t));
  }
  // a lower-priority boundary crossed inside a dominant medium is a
  // false hit: the path passes straight through
  const bool boundary = sm.boundary();
  const int32_t priority = sm.priority();
  const bool true_hit = !(boundary && priority > dom_pri);
  const float dom_ior = __ldg(med + 3);
  if ((true_hit && boundary && m.type() == kMatSmoothDielectric) ||
      !boundary)
    st.eta_i = dom_ior;
  if (!true_hit) {
    if (!s.backface)
      st.ms.push(s.mat_id, priority);
    else
      st.ms.remove(s.mat_id);
  }

  // emission (a light's row)
  const bool is_specular = sm.is_specular();
  const V3 emission = hit_emission(sc.lights.rows, s.light_ind);
  const bool emissive = length_sq(emission) > kEps;
  const bool direct_view = st.depth == 0 || !st.hit_nonspec;
  if (true_hit && emissive && direct_view) li = add(li, mul(beta, emission));

  // NEE: the light sample and its unshadowed term; traced below
  bool trace_nee = false;
  NeeSample ns;
  float w = 0.0f;
  V3 nee_pending = v3(0.0f, 0.0f, 0.0f), nee_beta = beta;
  if (p.use_mis) {
    // a BSDF-sampled ray hit a light: weigh against the NEE pdf
    if (true_hit && emissive && !direct_view && !is_specular) {
      const float* lr = light_row(sc.lights.rows, s.light_ind);
      const float lpdf = nee_pdf(st.prev_point, s.point, row_v3(lr, 9),
                                 __ldg(lr + 15), num_lights);
      if (lpdf > kEps)
        li = add(li, scale(mul(beta, emission),
                           power2_weight(st.prev_pdf, lpdf)));
    }
    // NEE from non-emissive, non-specular surfaces
    const bool do_nee = true_hit && !emissive && !is_specular;
    if (classic && do_nee) ++rays;
    if (do_nee && sc.lights.count > 0) {
      const BasedDraws<EventDraws> nd{&e, kDNee};
      ns = nee_sample(nd, sc.lights, s.point, fr, wi_local, m, st.eta_i,
                      true);
      if (ns.active) {
        if (!classic) ++rays;
        w = power2_weight(ns.light_pdf, ns.bsdf_pdf);
        trace_nee = true;
        // classic adds (beta * (contrib * shadow)) * w, mega ((beta *
        // contrib) * w) * shadow
        nee_pending = classic ? ns.contrib : scale(mul(beta, ns.contrib), w);
      }
    }
  }

  // BSDF sampling
  if (true_hit) {
    const BasedDraws<EventDraws> bd{&e, kDBsdf};
    const Sample bs =
        bsdf_sample(bd, m, neg(wi_local), s.backface, st.eta_i);
    const float pdf = fmaxf(bs.pdf, 0.01f);
    // medium stack push/pop on refraction through a true-hit boundary
    if (bs.wo.z < 0.0f) {
      if (!s.backface)
        st.ms.push(s.mat_id, priority);
      else
        st.ms.remove(s.mat_id);
    }
    beta = scale(mul(beta, bs.f), fabsf(bs.wo.z) / pdf);
    const float side = bs.wo.z > 0.0f ? 1.0f : -1.0f;
    o = add(s.point, scale(s.normal, side * kEps));
    d = normalize(to_world(bs.wo, fr));
    st.prev_pdf = pdf;
    st.prev_point = s.point;
    ++st.depth;
  } else {
    o = add(s.point, scale(d, kRayEps));  // pass straight through
  }
  const bool rr = st.depth > p.max_depth + 1;
  const float u_rr = rr ? e(kDRr) : 0.0f;
  st.hit_nonspec = st.hit_nonspec || !is_specular;

  if (trace_nee) {
    const Trace8 sh = trace_ray<kEngine, true>(
        sc, ns.origin.x, ns.origin.y, ns.origin.z, ns.dir.x, ns.dir.y,
        ns.dir.z, ns.max_t, -1, true);
    rows += sh.rows;
    const V3 shadow = v3(sh.s0, sh.s1, sh.s2);
    if (classic) {
      if (fmaxf(fmaxf(sh.s0, sh.s1), sh.s2) > 0.0f)
        li = add(li, scale(mul(nee_beta, mul(nee_pending, shadow)), w));
    } else {
      li = add(li, mul(nee_pending, shadow));
    }
  }

  // Russian roulette past max_depth
  if (rr) {
    const float p_surv = fminf(fmaxf(luminance(beta), 0.05f), 0.99f);
    if (u_rr > p_surv) return false;
    beta = v3(beta.x / p_surv, beta.y / p_surv, beta.z / p_surv);
  }
  if (st.depth >= kHardDepthCap) return false;
  ++st.lit;
  return st.lit < (classic ? kLitCap : kLitCap + 1);
}

// One bounce of the naive integrator's path (models/naive.py): BSDF
// sampling only, no NEE, MIS or Russian roulette, eta_i = 1, emission added
// after the sampling-validity break, at most max_depth bounces; bounce
// `depth` draws keyed by fold_in(fold_in(skey, depth), d) with the pixel
// id (the draw-key table's row `depth`); the next ray is unnormalized
// to_world(wo) from the side of wo.z.
template <int kEngine>
__device__ __forceinline__ bool naive_event(const SceneArgs& sc,
                                            const Params& p,
                                            const KeyPair* table,
                                            uint32_t pix_id, PathState& st,
                                            int32_t& rays, int32_t& rows) {
  V3& o = st.o;
  V3& d = st.d;
  V3& beta = st.beta;
  ++rays;
  const Trace8 h = trace_ray<kEngine, false>(sc, o.x, o.y, o.z, d.x, d.y,
                                             d.z, kBigT, -1, true);
  rows += h.rows;
  if (h.tri < 0) {
    st.li = add(st.li, mul(beta, sample_sky(d, p.sample_environment != 0)));
    return false;
  }
  HeldDraws e;
  e.id = pix_id;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    e.k[j] = __ldg(table + st.lit * kUniKeyDraws + j);
  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, o, d, h.t);
  const SurfHeld m =
      hold(surf(sc.mat_f32, sc.textures, s.mat_id, s.uv0, s.uv1));
  const Frame fr = frame(s.normal);
  const V3 wi_local = to_local(d, fr);
  const BasedDraws<HeldDraws> bd{&e, 0};
  const Sample bs = bsdf_sample(bd, m, neg(wi_local), s.backface, 1.0f);
  if (bs.pdf <= 0.0f || length_sq(bs.f) < kEps) return false;
  st.li = add(st.li,
              mul(hit_emission(sc.lights.rows, s.light_ind), beta));
  beta = scale(mul(beta, bs.f), fabsf(bs.wo.z) / fmaxf(bs.pdf, 1e-20f));
  d = to_world(bs.wo, fr);
  const float side = bs.wo.z > 0.0f ? 1.0f : -1.0f;
  o = add(s.point, scale(s.normal, side * kRayEps));
  ++st.lit;
  return st.lit < p.max_depth;
}

// Sample `keys` (its key row) of pixel (x, y): the primary ray (K7) and a
// new path; returns whether it takes any event (the naive schedule at
// max_depth 0 takes none).
__device__ __forceinline__ bool begin_sample(const Params& p,
                                             const uint32_t* keys, int32_t x,
                                             int32_t y, uint32_t pix_id,
                                             PathState& st) {
  float org[3], dir[3];
  camera_ray(p.cam, keys, static_cast<float>(x), static_cast<float>(y),
             pix_id, org, dir);
  start_path(st, v3(org[0], org[1], org[2]), v3(dir[0], dir[1], dir[2]),
             p.air_priority);
  return p.schedule != kScheduleNaive || p.max_depth > 0;
}

// What the plain K2-K4 functions return for one hit (shade_eval): point,
// normal, uv, backface, albedo, transmission, then NEE (contrib, light_pdf,
// wo_local, shadow origin, dir, max_t, active), the NEE direction's BSDF
// pdf, the BSDF sample (wo, f, pdf), mat_id and emissive. Draws use the
// mega keys draw_keys with id ids[i]; NEE is active on hits that are neither
// emissive nor specular.
__device__ __forceinline__ void shade_eval_one(const SceneArgs& sc,
                                               const uint32_t* draw_keys,
                                               V3 o, V3 d,
                                               float t, int32_t tri, float u,
                                               float v, uint32_t id,
                                               float eta_i, float* out) {
  const ShadeHit s = shade_fetch(sc.shade, tri, u, v, o, d, t);
  const Surf sm = surf(sc.mat_f32, sc.textures, s.mat_id, s.uv0, s.uv1);
  const SurfHeld m = hold(sm, true);
  const Frame fr = frame(s.normal);
  const V3 wi_local = to_local(d, fr);
  const V3 albedo = m.albedo();
  const float trans = m.trans();
  const bool emissive =
      length_sq(hit_emission(sc.lights.rows, s.light_ind)) > kEps;
  const TableDraws e{draw_keys, id};
  NeeSample ns;
  if (sc.lights.count > 0) {
    const BasedDraws<TableDraws> nd{&e, kDNee};
    ns = nee_sample(nd, sc.lights, s.point, fr, wi_local, m, eta_i,
                    tri >= 0 && !emissive && !sm.is_specular());
  } else {
    ns.contrib = ns.wo_local = ns.dir = v3(0.0f, 0.0f, 0.0f);
    ns.light_pdf = -1.0f;
    ns.origin = s.point;
    ns.max_t = 0.0f;
    ns.active = false;
  }
  const float bpdf = ns.active
                         ? ns.bsdf_pdf
                         : bsdf_pdf(m, neg(wi_local), ns.wo_local, eta_i);
  const BasedDraws<TableDraws> bd{&e, kDBsdf};
  const Sample bs = bsdf_sample(bd, m, neg(wi_local), s.backface, eta_i);
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

// Samples s0 .. s0+k-1 of each of the n pixels (px, py); sample s keyed by
// row s of keys [k, 8] (the camera) and its draw-key table table[s]
// (max(key_rows, 1) x 9 pairs). Persistent: each thread steps one event of its
// path per loop trip and takes the next sample or pixel when the path ends
// (see the header). counter: the next pixel, zero at the launch. lanes
// (nullable): the lane counters (tpt::add_lane_counts). Built twice, by
// the minimum of blocks of 128 an SM it asks ptxas for (the result does not
// depend on it). kMinBlocksWide holds ptxas to 64 registers (~490 bytes of
// spills, cached): the event's work done before its shadow ray leaves the
// trace few live values, and the warps it adds hide the traversal's
// latency (a mega 1080p sample 21.7 ms at 8, 22.1 at 10, 23.4 at 6, 24.3 at
// 5, 25.7 at ptxas' own 116 registers, four blocks; H100,
// tools/shade_attribution.py). A frame whose pixels do not fill that grid
// (256x256: 65,536 pixels against 135,168 threads) gains no warps from it
// and pays the spills (uni-mega-256 -2 to -3%, naive-256 -5 to -6%), so it
// takes kMinBlocksNarrow, ptxas' own count (launch_grid).
constexpr int kMinBlocksWide = 8;
constexpr int kMinBlocksNarrow = 1;
template <int kEngine, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
uni_mega_kernel(tpt::SceneArgs sc, tpt::Params p,
                const uint32_t* __restrict__ keys,
                const tpt::KeyPair* __restrict__ table, int32_t k,
                const int32_t* __restrict__ px,
                const int32_t* __restrict__ py, int64_t n,
                float* __restrict__ li_out, int32_t* __restrict__ rays_out,
                int32_t* __restrict__ rows_out,
                unsigned long long* __restrict__ counter,
                unsigned long long* __restrict__ lanes) {
  int32_t events = 0, calls = 0;
  int64_t i = tpt::next_id(counter);
  if (i < n) {
    int32_t x = px[i], y = py[i];
    uint32_t pix_id = static_cast<uint32_t>((y << 14) + x);
    int32_t s = 0, rays = 0, rows = 0;
    const uint32_t* row = keys;
    const tpt::KeyPair* trow = table;
    const int32_t nrows = tpt::key_rows(p.schedule, p.max_depth);
    const int64_t trows = int64_t{nrows > 0 ? nrows : 1} * tpt::kUniKeyDraws;
    tpt::V3 acc = tpt::v3(0.0f, 0.0f, 0.0f);
    tpt::PathState st;
    bool alive = tpt::begin_sample(p, row, x, y, pix_id, st);
    for (;;) {
      if (alive) {
        if (lanes != nullptr &&
            (threadIdx.x & 31) == __ffs(__activemask()) - 1)
          ++calls;
        alive = p.schedule == tpt::kScheduleNaive
                    ? tpt::naive_event<kEngine>(sc, p, trow, pix_id, st,
                                                rays, rows)
                    : tpt::path_event<kEngine>(sc, p, trow, i, pix_id, st,
                                               rays, rows);
        ++events;
      }
      if (alive) continue;
      // retire the path (the mega engine through RGB9E5) into the sum
      tpt::V3 li = st.li;
      if (p.schedule == tpt::kScheduleMega) li = tpt::round_rgb9e5(li);
      acc = tpt::add(acc, li);
      if (++s == k) {
        li_out[3 * i] = acc.x;
        li_out[3 * i + 1] = acc.y;
        li_out[3 * i + 2] = acc.z;
        rays_out[i] = rays;
        if (rows_out != nullptr) rows_out[i] = rows;
        i = tpt::next_id(counter);
        if (i >= n) break;
        x = px[i];
        y = py[i];
        pix_id = static_cast<uint32_t>((y << 14) + x);
        s = rays = rows = 0;
        acc = tpt::v3(0.0f, 0.0f, 0.0f);
      }
      row = keys + tpt::kKeyWords * static_cast<int64_t>(s);
      trow = table + trows * s;
      alive = tpt::begin_sample(p, row, x, y, pix_id, st);
    }
  }
  tpt::add_lane_counts<kThreads>(events, calls, lanes);
}

// The launch's scratch: scratch[0] the pixel counter, zeroed here, then
// from byte 16 on the camera rows of samples s0 .. s0+k-1 under (b0,
// b1), then their draw-key table kt: threads s < k write row s, the next
// ones the table's entries.
__global__ void __launch_bounds__(kThreads)
uni_mega_keys_kernel(uint32_t b0, uint32_t b1, uint32_t s0, int32_t k,
                     tpt::KeyTables kt,
                     unsigned long long* __restrict__ scratch) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s == 0) scratch[0] = 0ull;
  uint32_t* rows = reinterpret_cast<uint32_t*>(scratch + 2);
  if (s < k)
    tpt::sample_key_row(b0, b1, s0 + static_cast<uint32_t>(s),
                        rows + tpt::kKeyWords * s);
  else
    tpt::key_table_entry(kt, s - k, reinterpret_cast<tpt::KeyPair*>(
                                        rows + tpt::kKeyWords * int64_t{k}));
}

// K5's draw-key table for k samples of `schedule`.
tpt::KeyTables uni_keys(uint32_t b0, uint32_t b1, uint32_t s0, int32_t k,
                        int32_t schedule, int32_t max_depth) {
  return tpt::uni_key_tables(b0, b1, s0, k,
                             tpt::key_rows(schedule, max_depth));
}

struct DrawKeys {
  uint32_t w[18];  // draw_key(skey, d), d = 0..8
};

__global__ void __launch_bounds__(kThreads)
shade_eval_kernel(tpt::SceneArgs sc, DrawKeys dk,
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
      sc, dk.w, tpt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]),
      tpt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]), t[i], tri[i], u[i], v[i],
      static_cast<uint32_t>(ids[i]), eta_i[i],
      out + tpt::kShadeEvalCols * i);
}

// scene: the table pointers (bin: the threaded engine's, or null).
tpt::SceneArgs make_scene(const float* table, const float* tri_f32,
                          int32_t tri_cols, const float* shade,
                          const float* mat_f32, const float* light_f32,
                          int32_t num_lights, const float* textures,
                          const float* medium, const float* bin = nullptr,
                          int32_t bin_nodes = 0) {
  tpt::SceneArgs sc;
  sc.table = table;
  sc.shade = reinterpret_cast<const float4*>(shade);
  sc.mat_f32 = mat_f32;
  sc.bin = bin;
  sc.bin_nodes = bin_nodes;
  sc.tri_f32 = tri_f32;
  sc.tri_cols = tri_cols;
  sc.lights.rows = light_f32;
  sc.lights.count = num_lights;
  sc.textures = textures;
  sc.medium = medium;
  return sc;
}

bool schedule_ok(int32_t schedule) {
  return schedule == tpt::kScheduleClassic ||
         schedule == tpt::kScheduleMega || schedule == tpt::kScheduleNaive;
}

// K5's build for n pixels on engine kEngine (wide: kMinBlocksWide, when
// the pixels fill its resident grid) and that build's resident grid.
template <int kEngine>
int launch_grid(int64_t n, unsigned& blocks, bool& wide) {
  unsigned full = 0;
  int err = tpt::resident_grid<uni_mega_kernel<kEngine, kMinBlocksWide>,
                               kThreads>(INT64_MAX / 2, full);
  if (err != 0) return err;
  wide = n >= static_cast<int64_t>(full) * kThreads;
  return wide ? tpt::resident_grid<uni_mega_kernel<kEngine, kMinBlocksWide>,
                                   kThreads>(n, blocks)
              : tpt::resident_grid<
                    uni_mega_kernel<kEngine, kMinBlocksNarrow>, kThreads>(
                    n, blocks);
}

int launch_grid(int32_t engine, int64_t n, unsigned& blocks, bool& wide) {
  return engine == tpt::kEngineThreaded
             ? launch_grid<tpt::kEngineThreaded>(n, blocks, wide)
             : launch_grid<tpt::kEngineBvh8>(n, blocks, wide);
}

template <int kEngine>
void launch(bool wide, unsigned grid, cudaStream_t st,
            const tpt::SceneArgs& sc, const tpt::Params& p,
            const uint32_t* keys, const tpt::KeyPair* table, int32_t k,
            const int32_t* px, const int32_t* py, int64_t n, float* li,
            int32_t* rays, int32_t* rows, unsigned long long* ctr,
            unsigned long long* ln) {
  if (wide)
    uni_mega_kernel<kEngine, kMinBlocksWide><<<grid, kThreads, 0, st>>>(
        sc, p, keys, table, k, px, py, n, li, rays, rows, ctr, ln);
  else
    uni_mega_kernel<kEngine, kMinBlocksNarrow><<<grid, kThreads, 0, st>>>(
        sc, p, keys, table, k, px, py, n, li, rays, rows, ctr, ln);
}

}  // namespace

// Samples s0 .. s0+k-1 (k >= 1) of n pixels under the base key (b0, b1): shade:
// scene.shade_table [T, 16] (16-byte aligned), mat_f32 [M, 26]; li [n,3] f32
// the sum of each pixel's k radiances in sample order, rays [n] i32 and rows
// (null, or [n] i32: rows visited, BVH8 rows or threaded nodes) their sums.
// cam_params: 19 floats (host memory). scratch:
// tpt_render_unidirectional_scratch(k, schedule, max_depth) bytes of device
// memory (the pixel counter and the key tables), written by the key kernel on
// the stream, so launches that share it must be ordered (one stream). engine:
// kEngineBvh8 (0) or kEngineThreaded (1, with bin, the threaded tables of
// bin_nodes node records and bin_slots leaf triangles). Test arguments: blocks
// > 0 fixes the grid (0: the resident grid), lanes (null, or three u64 in
// device memory) as the kernel's. Returns the launches' cudaError_t.
extern "C" int tpt_render_unidirectional(
    const float* table, const float* tri_f32, int32_t tri_cols,
    const float* shade, const float* mat_f32, const float* light_f32,
    int32_t num_lights, const float* textures, const float* medium,
    const int32_t* px, const int32_t* py, int64_t n,
    const float* cam_params, uint32_t b0, uint32_t b1, uint32_t s0,
    int32_t k, int32_t max_depth, int32_t use_mis,
    int32_t sample_environment, int32_t schedule, int32_t air_priority,
    int32_t engine, const float* bin, int32_t bin_nodes, int32_t bin_slots,
    float* li, int32_t* rays, int32_t* rows, void* scratch, int32_t blocks,
    void* lanes, void* stream) {
  if (k < 1 || scratch == nullptr || blocks < 0 || !schedule_ok(schedule) ||
      shade == nullptr || mat_f32 == nullptr ||
      !tpt::engine_ok(engine, bin, bin_nodes, bin_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  unsigned grid = 0;
  bool wide = false;
  const int err = launch_grid(engine, n, grid, wide);
  if (err != 0) return err;
  if (blocks > 0) grid = static_cast<unsigned>(blocks);
  static const uint32_t kNoKeys[8] = {};
  const tpt::SceneArgs sc =
      make_scene(table, tri_f32, tri_cols, shade, mat_f32, light_f32,
                 num_lights, textures, medium, bin, bin_nodes);
  tpt::Params p;
  p.cam = tpt::make_camera(cam_params, kNoKeys);
  p.max_depth = max_depth;
  p.use_mis = use_mis;
  p.sample_environment = sample_environment;
  p.schedule = schedule;
  p.air_priority = air_priority;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ctr = static_cast<unsigned long long*>(scratch);
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(ctr + 2);
  const tpt::KeyPair* dkeys = reinterpret_cast<const tpt::KeyPair*>(
      keys + tpt::kKeyWords * int64_t{k});
  auto* ln = static_cast<unsigned long long*>(lanes);
  const tpt::KeyTables kt = uni_keys(b0, b1, s0, k, schedule, max_depth);
  const int64_t entries = k + tpt::key_table_entries(kt);
  uni_mega_keys_kernel<<<static_cast<unsigned>(
                             (entries + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>(b0, b1, s0, k, kt, ctr);
  if (engine == tpt::kEngineThreaded)
    launch<tpt::kEngineThreaded>(wide, grid, st, sc, p, keys, dkeys, k, px,
                                 py, n, li, rays, rows, ctr, ln);
  else
    launch<tpt::kEngineBvh8>(wide, grid, st, sc, p, keys, dkeys, k, px, py,
                             n, li, rays, rows, ctr, ln);
  return static_cast<int>(cudaGetLastError());
}

// The rows of a sample's draw-key table (tpt::key_rows: 0 is one row with
// no bounce level; -1: an unknown schedule).
extern "C" int32_t tpt_render_unidirectional_key_rows(int32_t schedule,
                                                      int32_t max_depth) {
  if (!schedule_ok(schedule) || max_depth < 0) return -1;
  return tpt::key_rows(schedule, max_depth);
}

// The bytes of scratch tpt_render_unidirectional needs for k samples of
// `schedule`: the pixel counter, k camera rows and the draw-key table.
extern "C" int64_t tpt_render_unidirectional_scratch(int32_t k,
                                                     int32_t schedule,
                                                     int32_t max_depth) {
  if (k < 1 || !schedule_ok(schedule) || max_depth < 0) return -1;
  return 16 + 4 * int64_t{tpt::kKeyWords} * k +
         static_cast<int64_t>(sizeof(tpt::KeyPair)) *
             tpt::key_table_entries(uni_keys(0u, 0u, 0u, k, schedule,
                                             max_depth));
}

// The resident grid tpt_render_unidirectional launches for n pixels on the
// current device (blocks of 128 threads). Returns a cudaError_t.
extern "C" int tpt_render_unidirectional_grid(int32_t engine, int64_t n,
                                              int32_t* blocks) {
  unsigned grid = 0;
  bool wide = false;
  const int err = launch_grid(engine, n, grid, wide);
  *blocks = static_cast<int32_t>(grid);
  return err;
}

// Test entry: the K2-K4 device functions once per hit; out [n, 38] f32
// (columns: shade_eval_one); keys: the 18 mega draw-key words (host
// memory); shade: scene.shade_table [T, 16], mat_f32 [M, 26]. Returns the
// launch's cudaError_t.
extern "C" int tpt_shade_eval(
    const float* shade, const float* mat_f32, const float* light_f32,
    int32_t num_lights, const float* textures, const float* medium,
    const float* o, const float* d, const float* t, const int32_t* tri,
    const float* u, const float* v, const int32_t* ids, const float* eta_i,
    int64_t n, const uint32_t* keys, float* out, void* stream) {
  if (n <= 0) return 0;
  DrawKeys dk;
  for (int w = 0; w < 18; ++w) dk.w[w] = keys[w];
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  shade_eval_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_scene(nullptr, nullptr, 0, shade, mat_f32, light_f32, num_lights,
                 textures, medium),
      dk, o, d, t, tri, u, v, ids, eta_i, n, out);
  return static_cast<int>(cudaGetLastError());
}
