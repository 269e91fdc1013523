// The VCM eye passes as three stages: the per-thread bodies that
// eye_walk.cu, eye_connect.cu and eye_gather.cu launch, in three flavours:
//
//   kEyeClassic   the classic VCM / SPPM pass (K13's VCM form with K9's
//                 fold): cudapathtracer_tpu/models/vcm.py:render_sample's
//                 eye pass (line 150) and ops/hashgrid.py:fold_neighbors
//                 (240); traced on the scene's engine
//   kEyeMegaVcm   K14's VCM / SPPM flavour: models/vcm_mega.py:
//                 _mk_eye_machine (322) with _pack_conn_table (148)
//   kEyeMegaBdpt  K14's BDPT flavour: the eye machine of
//                 models/bdpt_mega.py:render_sample (56)
//
// K14's flavours trace BVH8 on every scene, as JAX's make_fused_step does.
//
// 1. the eye walk: a path walks up to eye_depth bounces (raygen K7,
//    begin_eye_walk; then a bounce a call of eye_walk_bounce: closest hit
//    -> the sky on a miss -> hit fetch -> BSDF sample -> MIS step) and at
//    each valid non-delta vertex computes the strategies that need no
//    light vertex: s=0 and NEE (one shadow ray). eye_walk.cu runs it on
//    persistent lanes that step one bounce a loop trip and take the next
//    path when theirs ends (finish_eye_walk adds its counts). It stores
//    them, weighted and resolved, in the term slots implicit / nee [D,N,3]
//    (implicit holds the sky term at the depth where the walk escaped), and
//    writes the vertex record [D,N] that the other stages read: pos, the
//    shade normal, to_prev, thr, albedo, transmission, the material id
//    (its row of mat_f32 is the material, read by id), d_vcm,
//    d_vc, d_vm and the flags (kRec*). A hit writes every field; an escape
//    its flags and the sky term; a depth the walk did not reach only its
//    flags, 0, which the entry's start kernel writes into every depth
//    before the walk: no stage reads more of them.
// 2. the connections, pair (eye depth t, light row j, path i): record t
//    of path i against light vertex j (K12's buffers), in two steps. The
//    pair's gate before its ray: the record ran its strategies (kRecConn),
//    the light vertex is valid and not delta (conn_light).
//    eye_connect.cu queues the slots (t L + j) N + i of the pairs that
//    pass and zeroes the rows of conn [D,L,N,3] the gather reads (every
//    pair whose eye record passes); eye_connect_one then runs a queued
//    pair: one shadow ray and, where one is traced, its resolved
//    contribution into its row (zero where the ray is blocked), rays and
//    rows added with integer atomics. The gather reads no row of a pair
//    whose eye record has no strategies (dead, delta or invalid).
// 3. eye_gather_one: one thread per path adds the stored terms in the
//    flavour's JAX order, starting from zero, and folds the merge from the
//    record at its place: classic per depth the sky, s=0, NEE, the
//    connections j = 0, 1, ..., the merge (fold_neighbors), then the
//    splat's frame buffer; mega per depth the sky, s=0, the merge
//    (merge_mega), NEE, the connections, then the RGB9E5 retirement (K10).
//    These are the float32 additions of the fused per-pixel loop, in its
//    order; a strategy that contributed nothing adds +0, which leaves the
//    sum unchanged.
#pragma once

#include <cstdint>

#include "mega.cuh"
#include "tally.cuh"

namespace tpt {

constexpr int kEyeClassic = 0;
constexpr int kEyeMegaVcm = 1;
constexpr int kEyeMegaBdpt = 2;

// The record's flag bits; a record the walk did not reach is 0.
constexpr int32_t kRecValid = 1;     // a hit whose BSDF sample has pdf >= EPS
constexpr int32_t kRecNonDelta = 2;  // a hit on a non-delta surface
constexpr int32_t kRecEscaped = 4;   // the closest ray missed (the sky slot)
constexpr int32_t kRecEnd = 8;       // the walk's last record
constexpr int32_t kRecConn = kRecValid | kRecNonDelta;  // strategies ran

// The walk's records and terms, all [D, N] (element (t, i) at t n + i).
struct EyeRecs {
  float* pos;       // [D,N,3]
  float* n;         // [D,N,3] the shade-time normal
  float* to_prev;   // [D,N,3]
  float* thr;       // [D,N,3]
  float* albedo;    // [D,N,3]
  float* trans;
  int32_t* mat_id;
  float* d_vcm;
  float* d_vc;
  float* d_vm;
  int32_t* flags;
  float* implicit;  // [D,N,3] the sky at an escape, else s=0
  float* nee;       // [D,N,3]
  int64_t stride;   // N
};

// Every field of a hit's record but nee (stored after NEE's shadow ray).
__device__ __forceinline__ void store_record(const EyeRecs& r, int64_t k,
                                             const EyeVertex& e,
                                             int32_t flags, V3 implicit) {
  put3(r.pos, k, e.pos);
  put3(r.n, k, e.n);
  put3(r.to_prev, k, e.to_prev);
  put3(r.thr, k, e.thr);
  put3(r.albedo, k, e.albedo);
  r.trans[k] = e.trans;
  r.mat_id[k] = e.mat_id;
  r.d_vcm[k] = e.d_vcm;
  r.d_vc[k] = e.d_vc;
  r.d_vm[k] = e.d_vm;
  r.flags[k] = flags;
  put3(r.implicit, k, implicit);
}

// The record of a depth the walk escaped at: its flags and the sky term;
// the vertex fields are not written (no stage reads them).
__device__ __forceinline__ void store_escape(const EyeRecs& r, int64_t k,
                                             V3 sky) {
  r.flags[k] = kRecEscaped | kRecEnd;
  put3(r.implicit, k, sky);
}

__device__ __forceinline__ EyeVertex load_record(const EyeRecs& r,
                                                 int64_t k) {
  EyeVertex e;
  e.pos = get3(r.pos, k);
  e.n = get3(r.n, k);
  e.to_prev = get3(r.to_prev, k);
  e.thr = get3(r.thr, k);
  e.albedo = get3(r.albedo, k);
  e.trans = r.trans[k];
  e.d_vcm = r.d_vcm[k];
  e.d_vc = r.d_vc[k];
  e.d_vm = r.d_vm[k];
  e.mat_id = r.mat_id[k];
  return e;
}

struct EyeLaunch {
  SceneRefs sc;
  EyeParams p;
  PathBufs light;      // [light_rows, n_buf]
  GridRefs grid;       // rows null without the merge
  const int32_t* px;   // [n]
  const int32_t* py;
  const float* fb;     // classic: nullable, added to the result
  float* out;          // classic [n,3]; mega [P,3], row gbase + i
  int32_t* rays;       // [n] +=
  int32_t* dropped;    // [n] =
  int32_t* rows;       // [n] += or null
  // the stage's device counters or null (tally.cuh): walk [rows, rays],
  // connect [rows, rays, the warps' calls of the shadow ray, the pairs
  // queued, the slots D light_rows n]
  unsigned long long* tally;
  // the walk: its path counter (zeroed by its start kernel) and its lane
  // counters (persistent.cuh add_lane_counts) or null
  unsigned long long* counter;
  unsigned long long* lanes;
  EyeRecs rec;
  float* conn;         // [D, light_rows, n, 3]; null without connections
  uint32_t* queue;     // [D light_rows n] the connections' queue of slots
  uint32_t* queued;    // its length, counted on the card
  int64_t n;
  int flavor, engine;
};

// ---- 1. the eye walk ---------------------------------------------------

// A lane's eye path between two bounces: what one bounce hands the next.
struct EyeWalk {
  V3 o, d, thr, prev_pt;
  float prev_pdf, prev_cos;
  MisState ms;
  bool prev_delta;
  int depth;     // the bounce to step
  uint32_t id;   // the pixel id (py << 14) + px, the classic draws' key
  int32_t rays, rows;
};

// Path i's camera ray (K7) and the walk's state before its first bounce.
__device__ __forceinline__ void begin_eye_walk(const EyeLaunch& c, int64_t i,
                                               EyeWalk& w) {
  const EyeParams& p = c.p;
  const int32_t px = c.px[i], py = c.py[i];
  w.id = static_cast<uint32_t>((py << 14) + px);
  float org[3], dir[3];
  camera_ray(p.cam, static_cast<float>(px), static_cast<float>(py), w.id,
             org, dir);
  w.o = v3(org[0], org[1], org[2]);
  w.d = v3(dir[0], dir[1], dir[2]);
  const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
  const float cos_cam = fabsf(dot(fwd, w.d));
  w.prev_pdf = 1.0f / (p.plane_area * cube(cos_cam));
  w.prev_cos = cos_cam;
  w.thr = v3(1.0f, 1.0f, 1.0f);
  w.prev_pt = w.o;
  w.prev_delta = true;
  w.ms.d_vcm = w.ms.d_vc = w.ms.d_vm = w.ms.pdf_rev_prev = 0.0f;
  w.ms.prev_was_delta = false;
  w.depth = 0;
  w.rays = w.rows = 0;
}

// One bounce of path i at depth w.depth: the closest ray, the record (but
// NEE's term), the walk advanced, then NEE's shadow ray and its term.
// Returns whether the path goes on (false: it escaped, stopped, or this
// was its last depth).
template <int kFlavor, int kEngine>
__device__ __forceinline__ bool eye_walk_bounce(const EyeLaunch& c, int64_t i,
                                                EyeWalk& w) {
  constexpr bool kMega = kFlavor != kEyeClassic;
  constexpr bool kBdpt = kFlavor == kEyeMegaBdpt;
  const SceneRefs& sc = c.sc;
  const EyeParams& p = c.p;
  const Weighting& wt = p.weighting;
  const int depth = w.depth;
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const int64_t k = depth * c.rec.stride + i;
  ++w.rays;
  const Trace8 h = trace_ray<kEngine, false>(sc, w.o.x, w.o.y, w.o.z, w.d.x,
                                             w.d.y, w.d.z, kBigT, -1, true);
  w.rows += h.rows;
  if (h.tri < 0) {  // escaped: the sky, weight 1
    store_escape(c.rec, k, p.sample_environment
                               ? wt(mul(w.thr, sample_sky(w.d, true)), 1.0f)
                               : zero);
    return false;
  }
  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, w.o, w.d, h.t);
  const Surf sm = surf_of(sc, s.mat_id, s.uv0, s.uv1);
  const Frame fr = frame(s.normal);
  EyeVertex e;
  e.mat_id = s.mat_id;
  e.pos = s.point;
  e.n = s.normal;
  e.thr = w.thr;
  const V3 wo_local = to_local(w.d, fr);
  // the lobe's fields, the record's albedo and transmission resolved
  const SurfHeld m = hold(sm, true);
  e.albedo = m.albedo();
  e.trans = m.trans();
  const bool cur_delta = sm.is_specular();

  const float d2p = fmaxf(length_sq(sub(e.pos, w.prev_pt)), kRayEps);
  const float pdf_fwd_area = w.prev_pdf * fabsf(wo_local.z) / d2p;
  const float g = w.prev_cos / d2p;
  const uint32_t did =
      (kMega ? static_cast<uint32_t>(p.gbase + i) * kMegaIdStride : 0u) +
      static_cast<uint32_t>(depth);
  Sample bs;
  // classic: this depth's row of the key table (BSDF pairs, then NEE's)
  const KeyPair* krow =
      kMega ? nullptr : p.key_table + kEyeKeyDraws * depth;
  if constexpr (kMega) {
    bs = bsdf_sample(TableDraws{p.bsdf_keys, did}, m, neg(wo_local),
                     s.backface, 1.0f, true);
  } else {
    bs = bsdf_sample(RowDraws{krow, w.id}, m, neg(wo_local), s.backface,
                     1.0f, true);
  }
  const float pdf_rev_sa = bsdf_pdf(m, bs.wo, neg(wo_local), 1.0f);
  const bool valid = bs.pdf >= kEps;
  const MisState mv = mis_advance(
      w.ms, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
      1.0f / fmaxf(pdf_fwd_area, 1e-20f), 0.0f, 0.0f, !kBdpt, p.eta_vcm);
  e.d_vcm = mv.d_vcm;
  e.d_vc = mv.d_vc;
  e.d_vm = mv.d_vm;
  e.to_prev = normalize(sub(w.prev_pt, e.pos));

  V3 s0 = zero;
  const bool strategies = valid && !cur_delta;
  // s = 0: the eye walk hit a light
  if (strategies && p.naive && s.light_ind >= 0 && !s.backface) {
    if constexpr (kBdpt)
      s0 = implicit_bdpt(sc, p, s.light_ind, e, w.prev_pt, w.prev_delta,
                         depth);
    else
      s0 = implicit_vcm(sc, wt, s.light_ind, e, w.prev_delta, depth);
  }
  // SPPM ends the walk after its first non-delta surface
  const bool stop = !valid || (p.sppm && p.merge && !cur_delta);
  const bool last = stop || depth + 1 == p.eye_depth;
  const int32_t flags = (valid ? kRecValid : 0) |
                        (cur_delta ? 0 : kRecNonDelta) | (last ? kRecEnd : 0);
  store_record(c.rec, k, e, flags, s0);
  // NEE's inputs from the walk's state at this vertex, then the walk
  // advances, so that only NEE's own terms live across its shadow ray
  const bool do_nee = strategies && p.nee && sc.lights.count > 0;
  const V3 ptc_local =
      !kMega && do_nee ? to_local(sub(e.pos, w.prev_pt), fr) : zero;
  if (!last) {
    w.thr = scale(mul(w.thr, bs.f), fabsf(bs.wo.z) / fmaxf(bs.pdf, 1e-20f));
    const V3 wi_world = normalize(to_world(bs.wo, fr));
    const float side = dot(wi_world, e.n) < 0.0f ? -1.0f : 1.0f;
    w.o = add(e.pos, scale(e.n, side * kRayEps));
    w.d = wi_world;
    w.prev_pdf = bs.pdf;
    w.prev_cos = fabsf(bs.wo.z);
    w.prev_pt = e.pos;
    w.prev_delta = cur_delta;
    w.depth = depth + 1;
  }
  // s = 1: NEE
  V3 ne = zero;
  if (do_nee) {
    if constexpr (kMega) {
      // the normal toward the previous vertex, and its frame
      const bool flip = dot(e.n, e.to_prev) < 0.0f;
      EyeVertex ec = e;
      if (flip) ec.n = neg(e.n);
      ne = nee_mega<kBdpt>(sc, p, ec, flip ? frame(ec.n) : fr, m, did,
                           w.rays, w.rows);
    } else {
      ne = nee_vcm<kEngine>(sc, wt, p.eta_vcm, e, fr, m,
                            RowDraws{krow + kEyeNeeDraw, w.id}, ptc_local,
                            w.rays, w.rows);
    }
  }
  put3(c.rec.nee, k, ne);
  return !last;
}

// The ended path i's rays and rows into the pass's counts and the tally.
__device__ __forceinline__ void finish_eye_walk(const EyeLaunch& c,
                                                int64_t i, const EyeWalk& w) {
  c.rays[i] += w.rays;
  if (c.rows != nullptr) c.rows[i] += w.rows;
  if (c.tally != nullptr) tally_add(c.tally, w.rows, w.rays, false);
}

// ---- 2. the connections ------------------------------------------------

// The gate of pair (t, j, i) before its shadow ray: eye record t of path i
// holds kRecConn (it ran its strategies) and conn_light holds: light
// vertex j of lane i is valid and not delta.
__device__ __forceinline__ bool conn_light(const EyeLaunch& c, int j,
                                           int64_t i) {
  const int64_t kl = j * c.light.n + i;
  const uint32_t w = c.light.flags[kl];  // read with valid, not after it
  return c.light.valid[kl] && !unpack_flags(w).is_delta;
}

// Pair (t, j, i), one that passes the gate: eye record t of path i against
// light vertex j of lane i. Its row of conn is zero before the call (the
// queue pass writes it), and is written only where a ray is traced.
template <int kFlavor, int kEngine>
__device__ __forceinline__ void eye_connect_one(const EyeLaunch& c, int t,
                                                int j, int64_t i) {
  constexpr bool kMega = kFlavor != kEyeClassic;
  constexpr bool kBdpt = kFlavor == kEyeMegaBdpt;
  EyeVertex e = load_record(c.rec, t * c.rec.stride + i);
  if (kMega && dot(e.n, e.to_prev) < 0.0f) e.n = neg(e.n);
  const Vertex lv = load_vertex(c.light, j, i);
  ConnRay cr;
  int32_t rays = 0, rows = 0;
  if (!conn_ray<kEngine>(c.sc, e, lv, cr, rays, rows)) return;
  atomicAdd(c.rays + i, rays);
  if (c.rows != nullptr) atomicAdd(c.rows + i, rows);
  if (c.tally != nullptr) tally_add(c.tally, rows, rays, true);
  V3 out = v3(0.0f, 0.0f, 0.0f);
  if (max3(cr.sh.s0, cr.sh.s1, cr.sh.s2) > 0.0f) {
    float weight;
    const V3 base = conn_terms(c.sc, c.p.eta_vcm, e, lv, cr, weight);
    const Weighting& wt = c.p.weighting;
    if constexpr (kMega)
      out = resolve<kBdpt>(wt, wt(base, weight), cr.sh);
    else
      out = clamp_firefly(
          wt(mul(base, v3(cr.sh.s0, cr.sh.s1, cr.sh.s2)), weight));
  }
  put3(c.conn,
       (static_cast<int64_t>(t) * c.p.light_rows + j) * c.rec.stride + i,
       out);
}

// ---- 3. the merge and the ordered gather -------------------------------

template <int kFlavor>
__device__ __forceinline__ void eye_gather_one(const EyeLaunch& c,
                                               int64_t i) {
  constexpr bool kMega = kFlavor != kEyeClassic;
  const EyeParams& p = c.p;
  const int64_t n = c.rec.stride;
  const bool merge = p.merge && kFlavor != kEyeMegaBdpt;
  const bool conns = p.connection && c.conn != nullptr;
  V3 li = v3(0.0f, 0.0f, 0.0f);
  int32_t dropped = 0;
  for (int t = 0; t < p.eye_depth; ++t) {
    const int64_t k = t * n + i;
    const int32_t f = c.rec.flags[k];
    if (f == 0) break;
    if (f & kRecEscaped) {
      if (p.sample_environment) li = add(li, get3(c.rec.implicit, k));
      break;
    }
    if ((f & kRecConn) == kRecConn) {
      li = add(li, get3(c.rec.implicit, k));
      if (kMega && merge) {
        const EyeVertex e = load_record(c.rec, k);
        li = add(li, merge_mega(p, c.grid, e, held_of(c.sc, e), dropped));
      }
      li = add(li, get3(c.rec.nee, k));
      if (conns)
        for (int j = 0; j < p.light_rows; ++j)
          li = add(li, get3(c.conn, (static_cast<int64_t>(t) * p.light_rows +
                                     j) * n + i));
      if (!kMega && merge) {
        // the vertex resolved once a query: its lobe, frame and to_prev
        const EyeVertex e = load_record(c.rec, k);
        const SurfHeld m = held_of(c.sc, e);
        const Frame fe = frame(e.n);
        const V3 prev_loc = to_local(e.to_prev, fe);
        const float eta = fmaxf(p.eta_vcm, 1e-30f);
        const Weighting& wt = p.weighting;
        dropped += fold_neighbors(c.grid, e.pos, [&](const Photon& ph,
                                                     float w) {
          float weight;
          const V3 base = merge_term(e, m, fe, prev_loc, ph, eta, weight);
          li = add(li, wt(scale(scale(base, p.merge_norm), w), weight));
        });
      }
    }
    if (f & kRecEnd) break;
  }
  if constexpr (kMega) {
    put3(c.out, p.gbase + i, round_rgb9e5(li));
  } else {
    if (c.fb != nullptr) li = add(li, get3(c.fb, i));
    put3(c.out, i, li);
  }
  c.dropped[i] = dropped;
}

// ---- host side: the C entries' argument block ------------------------------

// The layout the three entries (eye_walk.cu, eye_connect.cu,
// eye_gather.cu) share.
// ptrs: 0 table, 1 tri_f32, 2 light_f32, 3 mat_f32, 4 textures, 5 px,
// 6 py, 7-17 the 11 light-buffer fields [light_rows, n_buf], 18 grid rows,
// 19 cell_se (0, 0 without the merge), 20 fb (classic; 0 = none), 21 out,
// 22 rays, 23 dropped, 24 rows (0 = none), 25 the threaded tables (0 under
// BVH8), 26-38 the records: pos, n, to_prev, thr, albedo, trans, mat_id,
// d_vcm, d_vc, d_vm, flags, implicit, nee; 39 conn (0 without
// connections), 40 shade_table [T, 16], 41 the classic walk's key table
// (eye_depth x 7 pairs of scratch, written by eye_walk.cu's prologue from
// the eye key; 0 for mega), 42 the stage's tally (0 = none), 43 the
// connections' queue [eye_depth light_rows n] u32 and 44 its length (one
// u32), scratch of the connection stage (0 without connections), 45 the
// walk's path counter (one u64 of scratch; launches that share it must be
// ordered) and 46 its lane counters (three u64; 0 = none).
// iv: 0 n (paths), 1 n_buf (the light buffers' lanes), 2 tri_cols,
// 3 num_lights, 4 eye_depth, 5 light_rows, 6 flavor, 7 naive, 8 nee,
// 9 connection, 10 do_mis, 11 paint_weight, 12 sample_environment,
// 13 merge, 14 sppm, 15 table_size, 16 max_per_cell, 17 one_brick,
// 18 reweight, 19 grid rows P8, 20 gbase, 21 engine, 22 bin nodes,
// 23 bin slots, 24 the walk's blocks (0: the resident grid; a test
// argument).
// fv: the 19 camera floats, plane_area, eta_vcm, merge_norm,
// scene_min[3], cell_size, merge radius squared.
// keys (22 words): the 8 camera draw-key words, then classic: 2 unused,
// the eye key pair; mega: the BSDF draw keys 0-3 and NEE's 16-18.
inline bool eye_launch(const int64_t* ptrs, const int64_t* iv,
                       const float* fv, const uint32_t* keys, EyeLaunch& c) {
  c.n = iv[0];
  const int64_t n_buf = iv[1];
  c.sc.table = dev_ptr<const float>(ptrs, 0);
  c.sc.tri_f32 = dev_ptr<const float>(ptrs, 1);
  c.sc.tri_cols = static_cast<int>(iv[2]);
  c.sc.lights.rows = dev_ptr<const float>(ptrs, 2);
  c.sc.lights.count = static_cast<int32_t>(iv[3]);
  c.sc.mat_f32 = dev_ptr<const float>(ptrs, 3);
  c.sc.textures = dev_ptr<const float>(ptrs, 4);
  c.px = dev_ptr<const int32_t>(ptrs, 5);
  c.py = dev_ptr<const int32_t>(ptrs, 6);
  c.flavor = static_cast<int>(iv[6]);
  EyeParams& p = c.p;
  p.cam = make_camera(fv, keys);
  p.plane_area = fv[19];
  p.eta_vcm = fv[20];
  p.merge_norm = fv[21];
  p.key_e0 = keys[10];
  p.key_e1 = keys[11];
  for (int k = 0; k < 8; ++k) p.bsdf_keys[k] = keys[8 + k];
  for (int k = 0; k < 6; ++k) p.nee_keys[k] = keys[16 + k];
  p.eye_depth = static_cast<int>(iv[4]);
  p.light_rows = static_cast<int>(iv[5]);
  p.naive = iv[7] != 0;
  p.nee = iv[8] != 0;
  p.connection = iv[9] != 0;
  p.weighting.do_mis = iv[10] != 0;
  p.weighting.paint_weight = iv[11] != 0;
  p.sample_environment = iv[12] != 0;
  p.merge = iv[13] != 0;
  p.sppm = iv[14] != 0;
  p.gbase = iv[20];
  c.light = path_bufs(ptrs + 7, n_buf, p.light_rows);
  GridRefs& g = c.grid;
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
  c.fb = dev_ptr<const float>(ptrs, 20);
  c.out = dev_ptr<float>(ptrs, 21);
  c.rays = dev_ptr<int32_t>(ptrs, 22);
  c.dropped = dev_ptr<int32_t>(ptrs, 23);
  c.rows = dev_ptr<int32_t>(ptrs, 24);
  c.engine = engine_refs(ptrs, 25, iv, 21, c.sc);
  EyeRecs& r = c.rec;
  r.pos = dev_ptr<float>(ptrs, 26);
  r.n = dev_ptr<float>(ptrs, 27);
  r.to_prev = dev_ptr<float>(ptrs, 28);
  r.thr = dev_ptr<float>(ptrs, 29);
  r.albedo = dev_ptr<float>(ptrs, 30);
  r.trans = dev_ptr<float>(ptrs, 31);
  r.mat_id = dev_ptr<int32_t>(ptrs, 32);
  r.d_vcm = dev_ptr<float>(ptrs, 33);
  r.d_vc = dev_ptr<float>(ptrs, 34);
  r.d_vm = dev_ptr<float>(ptrs, 35);
  r.flags = dev_ptr<int32_t>(ptrs, 36);
  r.implicit = dev_ptr<float>(ptrs, 37);
  r.nee = dev_ptr<float>(ptrs, 38);
  r.stride = c.n;
  c.conn = dev_ptr<float>(ptrs, 39);
  c.sc.shade = dev_ptr<const float4>(ptrs, 40);
  p.key_table = dev_ptr<const KeyPair>(ptrs, 41);
  c.tally = dev_ptr<unsigned long long>(ptrs, 42);
  c.queue = dev_ptr<uint32_t>(ptrs, 43);
  c.queued = dev_ptr<uint32_t>(ptrs, 44);
  c.counter = dev_ptr<unsigned long long>(ptrs, 45);
  c.lanes = dev_ptr<unsigned long long>(ptrs, 46);
  const bool mega = c.flavor != kEyeClassic;
  const bool merge = p.merge && c.flavor != kEyeMegaBdpt;
  bool grid_ok = !merge || (g.rows != nullptr && g.cell_se != nullptr &&
                            g.geom.table_size > 0 && g.cap >= 1);
  if (mega && merge) grid_ok = grid_ok && g.n_rows >= 16 && g.n_rows % 8 == 0;
  const bool recs_ok = r.pos && r.n && r.to_prev && r.thr && r.albedo &&
                       r.trans && r.mat_id && r.d_vcm && r.d_vc && r.d_vm &&
                       r.flags && r.implicit && r.nee;
  return c.sc.shade != nullptr && (mega || p.key_table != nullptr) &&
         c.flavor >= kEyeClassic &&
         c.flavor <= kEyeMegaBdpt &&
         p.eye_depth >= 1 && p.light_rows >= (mega ? 0 : 1) &&
         c.n <= n_buf && grid_ok && recs_ok && c.engine >= 0 &&
         (!mega || c.engine == kEngineBvh8);
}

}  // namespace tpt
