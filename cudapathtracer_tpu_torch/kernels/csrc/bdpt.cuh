// K11-K13 device code: the per-thread bodies of the BDPT kernels and the
// packed path-vertex buffers they share.
//
//   start_walk, begin_walk, walk_bounce, finish_walk
//                  K12: an eye or light walk's endpoint (drawn by the
//                  prologue, read back by the walk), one bounce, its end
//                  (models/paths.py:129,219,237); its table mode is
//                  models/light_mega.py:108's keyed walk
//   splat_tile     K11's first stage: whether a light vertex traces to
//                  the lens, and the screen tile of its pixel
//   splat_vertex   K11: one light vertex to the lens (models/bdpt.py:93;
//                  VCM's form, models/vcm.py:87, adds eta_vcm)
//   pair_term      K13's first stage: one NEE or connection shadow ray
//                  of one eye vertex (models/bdpt.py:175,226)
//   gather_pixel   K13's second stage: one pixel's ordered sum
//
// bdpt_walk.cu, bdpt_splat.cu, bdpt_pairs.cu and bdpt_gather.cu launch
// them: one bounce of the path a persistent lane holds a loop trip, one
// thread per light path (classify) and per queued light vertex (trace),
// per (eye vertex, strategy, pixel) and per pixel. The buffers are
// depth-major
// [D, N] in the JAX package's packed layout (models/paths.PathBuffers):
// the walk keeps its state unpacked in registers and stores each vertex
// through the K10 codecs (packing.cuh); the splat and the connections read
// the DECODED vertices, as the JAX stages do. The light endpoint (s = 1)
// is kept unpacked (v0 arrays). Every draw is keyed by the pixel id
// (py << 14) + px, one cipher a draw under its pair from a key table
// (keys.cuh) that a prologue folds on the card, where it depends on depth
// (the walk's bounce_key(key, depth), K13's fold_in(key_c, t)).
//
// Arithmetic follows the plain versions (models/paths.py, models/bdpt.py)
// operation for operation; the files are built with -fmad=false. x**3 and
// x**4 are XLA's integer_pow products x (x x) and (x x)(x x).
//
// The bodies that trace (all but gather_pixel) are templates on the
// traversal engine (traverse_bin.cuh: kEngineBvh8 traces with K1,
// kEngineThreaded with K15), and each entry launches the scene's; K12's
// table mode (the keyed walk, which stands for the JAX light_mega's fused
// BVH8 step) is launched with BVH8 on every scene. The launch arrays end
// with the engine's fields: ptrs the threaded tables, iv the engine, their
// nodes and slots (engine_refs).
#pragma once

#include <cuda_fp16.h>

#include <cstdint>

#include "bsdf.cuh"
#include "camera.cuh"
#include "keys.cuh"
#include "mis.cuh"
#include "nee.cuh"
#include "packing.cuh"
#include "shade.cuh"
#include "threefry.cuh"
#include "traverse_bin.cuh"

namespace tpt {

constexpr float kMaxGNee = 15.0f;
constexpr float kMaxGConnect = 2.0f;
constexpr float kMaxFireflyLum = 5.0f;

// ---- packed buffers --------------------------------------------------------

// One walk's buffers, all [D, N]; element (j, i) is vertex j + 1 of path i.
struct PathBufs {
  float* pt;          // [D,N,3]
  uint32_t* n_oct;    // [D,N]
  uint32_t* wo_oct;   // [D,N] unit vector toward the previous vertex
  __half* uv;         // [D,N,2]
  __half* beta;       // [D,N,3]
  float* pdf_fwd;
  float* d_vcm;
  float* d_vc;
  float* d_vm;
  uint32_t* flags;
  bool* valid;
  int64_t n;
  int depth;
};

// A decoded vertex (the connection and splat stages' view).
struct Vertex {
  V3 pt, n, wo, beta;
  float u, v;  // uv
  float pdf_fwd, d_vcm, d_vc;
  bool valid, is_delta, backface;
  int32_t light_ind, mat_id;
};

__device__ __forceinline__ Vertex load_vertex(const PathBufs& b, int j,
                                              int64_t i) {
  const int64_t k = j * b.n + i;
  Vertex v;
  v.valid = b.valid[k];
  v.pt = v3(b.pt[3 * k], b.pt[3 * k + 1], b.pt[3 * k + 2]);
  v.n = unpack_oct(b.n_oct[k]);
  v.wo = unpack_oct(b.wo_oct[k]);
  v.beta = load_half3(b.beta + 3 * k);
  v.u = __half2float(b.uv[2 * k]);
  v.v = __half2float(b.uv[2 * k + 1]);
  v.pdf_fwd = b.pdf_fwd[k];
  v.d_vcm = b.d_vcm[k];
  v.d_vc = b.d_vc[k];
  const Flags f = unpack_flags(b.flags[k]);
  v.is_delta = f.is_delta;
  v.backface = f.backface;
  v.light_ind = f.light_ind;
  v.mat_id = f.mat_id;
  return v;
}

__device__ __forceinline__ void store_vertex(const PathBufs& b, int j,
                                             int64_t i, V3 pt, V3 n, V3 wo,
                                             float u, float v, V3 beta,
                                             float pdf_fwd, float d_vcm,
                                             float d_vc, float d_vm,
                                             uint32_t flags, bool valid) {
  const int64_t k = j * b.n + i;
  b.pt[3 * k] = pt.x;
  b.pt[3 * k + 1] = pt.y;
  b.pt[3 * k + 2] = pt.z;
  b.n_oct[k] = pack_oct(n);
  b.wo_oct[k] = pack_oct(wo);
  b.uv[2 * k] = __float2half_rn(u);
  b.uv[2 * k + 1] = __float2half_rn(v);
  store_half3(b.beta + 3 * k, beta);
  b.pdf_fwd[k] = pdf_fwd;
  b.d_vcm[k] = d_vcm;
  b.d_vc[k] = d_vc;
  b.d_vm[k] = d_vm;
  b.flags[k] = flags;
  b.valid[k] = valid;
}

// A vertex the walk did not reach: only `valid` is read downstream.
__device__ __forceinline__ void store_dead(const PathBufs& b, int j,
                                           int64_t i) {
  const V3 z = v3(0.0f, 0.0f, 0.0f);
  store_vertex(b, j, i, z, v3(0.0f, 0.0f, 1.0f), v3(0.0f, 0.0f, 1.0f), 0.0f,
               0.0f, z, 0.0f, 0.0f, 0.0f, 0.0f, 0u, false);
}

// ---- shared pieces ---------------------------------------------------------

struct SceneRefs {
  const float* table;     // bvh8_table [R, 96]
  const float* tri_f32;   // [T, tri_cols] (shadow rays: MAT_LEAF rows)
  int tri_cols;
  const float4* shade;    // shade_table [T, 16] (shade.cuh)
  Lights lights;          // light_f32 [L, 17]
  const float* mat_f32;   // [M, 26]
  const float* textures;  // [A, 3]
  const float* bin;       // bin_table (threaded engine, traverse_bin.cuh)
  int32_t bin_nodes;      // its node records
};

struct LightPoint {
  int32_t li, tri;
  V3 p, n, le;
  float area;
};

// Uniform light pick + sqrt-warp area sample with the INTERPOLATED normal
// (draws 0, 1, 2: pick, u, v).
template <class Draw>
__device__ __forceinline__ LightPoint light_point(const Draw& draw,
                                                  const SceneRefs& sc) {
  const int32_t count = sc.lights.count > 1 ? sc.lights.count : 1;
  const float num = static_cast<float>(count);
  int32_t idx = static_cast<int32_t>(draw(0) * num);
  idx = idx < count - 1 ? idx : count - 1;
  const float* r = sc.lights.rows + 17 * static_cast<int64_t>(idx);
  LightPoint lp;
  lp.li = idx;
  lp.tri = row_i32(r, 16);
  const V3 a = row_v3(r, 0), b = row_v3(r, 3), c = row_v3(r, 6);
  lp.le = row_v3(r, 12);
  lp.area = __ldg(r + 15);
  V3 n0, n1, n2;
  vertex_normals(sc.shade, lp.tri, n0, n1, n2);
  const float u = sqrtf(draw(1));
  const float v = draw(2);
  const float w0 = 1.0f - u, w1 = u * (1.0f - v), w2 = u * v;
  lp.p = add(add(scale(a, w0), scale(b, w1)), scale(c, w2));
  lp.n = normalize(add(add(scale(n0, w0), scale(n1, w1)), scale(n2, w2)));
  return lp;
}

__device__ __forceinline__ float cube(float x) { return x * (x * x); }

__device__ __forceinline__ float fourth(float x) {
  const float x2 = x * x;
  return x2 * x2;
}

// The material of a hit or a stored vertex (mat_id, uv): bsdf.cuh Surf.
__device__ __forceinline__ Surf surf_of(const SceneRefs& sc, int32_t mat_id,
                                        float u, float v) {
  return surf(sc.mat_f32, sc.textures, mat_id, u, v);
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

struct Weighting {
  bool do_mis, paint_weight;
  __device__ __forceinline__ V3 operator()(V3 contrib, float w) const {
    if (paint_weight) return v3(w, w, w);
    return do_mis ? scale(contrib, w) : contrib;
  }
};

// ---- K12: the walk ---------------------------------------------------------

constexpr int kModeEye = 0;
constexpr int kModeLight = 1;

struct WalkParams {
  CameraParams cam;        // eye mode: raygen (camera draw keys inside)
  float plane_area;        // eye mode
  uint32_t key0, key1;     // the walk key (bounce keys derive from it)
  // The walk's key table (device memory, keys.cuh walk_key_tables):
  // [max_depth][4] bounce pairs (row b: draws 0-3 of bounce_key(key, b)),
  // then the 5 endpoint pairs (draws 100..104 of key). A kernel queued
  // before the walk's prologue folds it from key0, key1 (build), or the
  // host folded it (the keyed walk's rng.draw_key_table; the same bits).
  const KeyPair* key_table;
  int mode, max_depth;
  bool radiance;           // transport: radiance (eye) or importance
  bool use_vm;             // VCM d_vm chain
  float eta_vcm;
};

// Endpoint outputs: eye v0_pt; light all v0 arrays; eye escape arrays.
struct WalkOut {
  PathBufs bufs;
  float* v0_pt;
  float* v0_n;
  float* v0_beta;
  float* v0_pdf;
  int32_t* v0_light;
  int32_t* v0_mat;
  int32_t* v0_tri;
  bool* esc_valid;
  float* esc_d;
  float* esc_beta;
  int32_t* rays;   // += closest rays of the walk
  int32_t* rows;   // nullable: += BVH8 rows visited
  float* start;    // light mode: [N,4] the emitted direction and its |cos|
};

__device__ __forceinline__ void put3(float* dst, int64_t i, V3 a) {
  dst[3 * i] = a.x;
  dst[3 * i + 1] = a.y;
  dst[3 * i + 2] = a.z;
}

__device__ __forceinline__ V3 get3(const float* src, int64_t i) {
  return v3(src[3 * i], src[3 * i + 1], src[3 * i + 2]);
}

// One walk between two bounces: the registers K12's loop keeps for the
// path a lane holds. j is the next buffer row the walk writes (vertex
// j + 1, at depth j + 1): a bounce that misses writes no row, one whose
// BSDF sample is invalid writes its row and ends the walk.
struct WalkState {
  V3 o, d, thr, prev_pt;
  float prev_pdf, prev_cos, first_vc, first_vm;
  MisState ms;
  int32_t rays, rows;
  uint32_t id;
  int j;
};

__device__ __forceinline__ uint32_t pixel_id(int32_t px, int32_t py) {
  return static_cast<uint32_t>((py << 14) + px);
}

// The endpoint of path i, drawn once for every path before the walk (the
// walk's prologue, one thread a path): eye, the camera ray into v0_pt and
// the escape record of a walk that does not escape (the direction and a
// throughput of one); light, the light point into every v0 array and the
// emitted direction and its |cos| into out.start.
__device__ __forceinline__ void start_walk(const SceneRefs& sc,
                                           const WalkParams& p,
                                           const WalkOut& out, int64_t i,
                                           int32_t px, int32_t py) {
  const uint32_t id = pixel_id(px, py);
  if (p.mode == kModeEye) {
    float org[3], dir[3];
    camera_ray(p.cam, static_cast<float>(px), static_cast<float>(py), id, org,
               dir);
    put3(out.v0_pt, i, v3(org[0], org[1], org[2]));
    out.esc_valid[i] = false;
    put3(out.esc_d, i, v3(dir[0], dir[1], dir[2]));
    put3(out.esc_beta, i, v3(1.0f, 1.0f, 1.0f));
    return;
  }
  const RowDraws ld{p.key_table + kWalkKeyDraws * p.max_depth, id};
  const LightPoint lp = light_point(ld, sc);
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const float pdf0 = (1.0f / num) / fmaxf(lp.area, 1e-20f);
  const V3 out_local = cosine_sample(ld(3), ld(4));
  const V3 out_world = to_world(out_local, frame(lp.n));
  put3(out.v0_pt, i, lp.p);
  put3(out.v0_n, i, lp.n);
  put3(out.v0_beta, i, scale(lp.le, kPi / pdf0));
  out.v0_pdf[i] = pdf0;
  out.v0_light[i] = lp.li;
  out.v0_mat[i] = record_mat(sc.shade, lp.tri);
  out.v0_tri[i] = lp.tri;
  float* st = out.start + 4 * i;
  st[0] = out_world.x;
  st[1] = out_world.y;
  st[2] = out_world.z;
  st[3] = fabsf(out_local.z);
}

// Path i's state at depth 1, from what start_walk stored: the same values
// (the same operations on the same floats) as drawing the endpoint here.
__device__ __forceinline__ void begin_walk(const WalkParams& p,
                                           const WalkOut& out, int64_t i,
                                           int32_t px, int32_t py,
                                           WalkState& st) {
  st.id = pixel_id(px, py);
  if (p.mode == kModeEye) {
    st.o = get3(out.v0_pt, i);
    st.d = get3(out.esc_d, i);
    const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
    const float cos_cam = fabsf(dot(fwd, st.d));
    st.prev_pdf = 1.0f / (p.plane_area * cube(cos_cam));
    st.prev_cos = cos_cam;
    st.thr = v3(1.0f, 1.0f, 1.0f);
    st.prev_pt = st.o;
    st.first_vc = 0.0f;
  } else {
    const V3 lp_p = get3(out.v0_pt, i), lp_n = get3(out.v0_n, i);
    const float* sv = out.start + 4 * i;
    const float cos_emit = sv[3];
    st.o = add(lp_p, scale(lp_n, kRayEps));
    st.d = v3(sv[0], sv[1], sv[2]);
    st.thr = get3(out.v0_beta, i);
    st.prev_pdf = cos_emit / kPi;
    st.prev_cos = cos_emit;
    st.prev_pt = lp_p;
    st.first_vc = 1.0f / fmaxf(out.v0_pdf[i], 1e-20f);
  }
  st.first_vm = p.use_vm ? st.first_vc / fmaxf(p.eta_vcm, 1e-30f) : 0.0f;
  st.ms.d_vcm = st.ms.d_vc = st.ms.d_vm = st.ms.pdf_rev_prev = 0.0f;
  st.ms.prev_was_delta = false;
  st.rays = st.rows = 0;
  st.j = 0;
}

// One bounce of the walk at depth st.j + 1 (< max_depth): the closest ray
// (K1 or K15), the hit fetch (K2), the BSDF sample (K3), the MIS step and
// the packed vertex store (K10). Returns whether the walk goes on.
template <int kEngine>
__device__ __forceinline__ bool walk_bounce(const SceneRefs& sc,
                                            const WalkParams& p,
                                            const WalkOut& out, int64_t i,
                                            WalkState& st) {
  const int depth = st.j + 1;
  ++st.rays;
  const Trace8 h = trace_ray<kEngine, false>(sc, st.o.x, st.o.y, st.o.z,
                                             st.d.x, st.d.y, st.d.z, kBigT,
                                             -1, true);
  st.rows += h.rows;
  if (h.tri < 0) {  // the first miss: the walk escapes
    if (out.esc_valid != nullptr) {
      out.esc_valid[i] = true;
      put3(out.esc_d, i, st.d);
      put3(out.esc_beta, i, st.thr);
    }
    return false;
  }
  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, st.o, st.d, h.t);
  const Surf sm = surf_of(sc, s.mat_id, s.uv0, s.uv1);
  const SurfHeld m = hold(sm);
  const V3 normal = s.normal;
  const Frame fr = frame(normal);
  const V3 wo_local = to_local(st.d, fr);  // incoming, z < 0

  const float d2 = fmaxf(length_sq(sub(s.point, st.prev_pt)), kRayEps);
  const float pdf_fwd_area = st.prev_pdf * fabsf(wo_local.z) / d2;
  const float g = st.prev_cos / d2;

  const RowDraws bd{p.key_table + kWalkKeyDraws * depth, st.id};
  const Sample bs = bsdf_sample(bd, m, neg(wo_local), s.backface, 1.0f,
                                p.radiance);
  const float pdf_rev_sa = bsdf_pdf(m, bs.wo, neg(wo_local), 1.0f);
  const bool is_specular = sm.is_specular();

  const float safe_fwd = fmaxf(pdf_fwd_area, 1e-20f);
  const MisState mv = mis_advance(
      st.ms, depth == 1, pdf_fwd_area, g, pdf_rev_sa, is_specular,
      1.0f / safe_fwd, st.first_vc * g / safe_fwd,
      p.use_vm ? st.first_vm * g / safe_fwd : 0.0f, p.use_vm, p.eta_vcm);

  const bool valid = bs.pdf >= kEps;
  store_vertex(out.bufs, st.j, i, s.point, normal, normalize(neg(st.d)),
               s.uv0, s.uv1, st.thr, pdf_fwd_area, mv.d_vcm, mv.d_vc,
               mv.d_vm,
               pack_flags(is_specular, s.backface, s.light_ind, s.mat_id),
               valid);
  ++st.j;
  if (!valid) return false;
  // continue the walk
  st.thr = scale(mul(st.thr, bs.f), fabsf(bs.wo.z) / fmaxf(bs.pdf, 1e-20f));
  const V3 wi_world = normalize(to_world(bs.wo, fr));
  const float side = dot(wi_world, normal) < 0.0f ? -1.0f : 1.0f;
  st.o = add(s.point, scale(normal, side * kRayEps));
  st.d = wi_world;
  st.prev_pdf = bs.pdf;
  st.prev_cos = fabsf(bs.wo.z);
  st.prev_pt = s.point;
  return st.j < out.bufs.depth;
}

// The end of path i's walk: rays[i] and rows[i] += the walk's counts (the
// prologue wrote the dead pattern into the rows it did not reach).
__device__ __forceinline__ void finish_walk(const WalkOut& out, int64_t i,
                                            const WalkState& st) {
  out.rays[i] += st.rays;
  if (out.rows != nullptr) out.rows[i] += st.rows;
}

// ---- K11: the light-trace splat --------------------------------------------

struct SplatParams {
  CameraParams cam;
  float plane_area;
  int width, height;
  Weighting weighting;
  bool vcm;        // VCM's form: eta_vcm joins a stored vertex's w_light
  float eta_vcm;
};

// The unpacked light endpoint (s = 1) of path i.
struct Endpoint {
  const float* pt;
  const float* n;
  const float* beta;
  const float* pdf;
  const int32_t* mat;
};

// The pixel a raster point splats into: truncated, then clipped.
__device__ __forceinline__ void splat_pixel(const SplatParams& p, float rx,
                                            float ry, int32_t& ix,
                                            int32_t& iy) {
  iy = static_cast<int32_t>(ry);
  ix = static_cast<int32_t>(rx);
  iy = iy < 0 ? 0 : (iy > p.height - 1 ? p.height - 1 : iy);
  ix = ix < 0 ? 0 : (ix > p.width - 1 ? p.width - 1 : ix);
}

// K11's first stage: -1 where light vertex j of path i traces nothing
// (invalid, delta or off screen: splat_vertex's test before its shadow
// ray), else the screen tile of its pixel (tile x tile pixels, tiles_x a
// row of tiles).
__device__ __forceinline__ int32_t splat_tile(const SplatParams& p,
                                              const PathBufs& lb,
                                              const Endpoint& e, int j,
                                              int64_t i, int tile,
                                              int tiles_x) {
  float pt[3];
  if (j == 0) {
    for (int c = 0; c < 3; ++c) pt[c] = e.pt[3 * i + c];
  } else {
    const int64_t k = (j - 1) * lb.n + i;
    if (!lb.valid[k] || unpack_flags(lb.flags[k]).is_delta) return -1;
    for (int c = 0; c < 3; ++c) pt[c] = lb.pt[3 * k + c];
  }
  float rx, ry;
  if (!world_to_raster(p.cam, pt, rx, ry)) return -1;
  int32_t ix, iy;
  splat_pixel(p, rx, ry, ix, iy);
  return (iy / tile) * tiles_x + ix / tile;
}

// Light vertex j of path i (j = 0: the endpoint; j >= 1: stored row j - 1)
// to the lens; adds into fb [P,3] with atomics (splat_tile's stage counts
// the ray into rays[i]).
template <int kEngine>
__device__ __forceinline__ void splat_vertex(const SceneRefs& sc,
                                             const SplatParams& p,
                                             const PathBufs& lb,
                                             const Endpoint& e, int j,
                                             int64_t i, float* fb,
                                             int32_t* rows) {
  const bool first = j == 0;
  Vertex v;
  if (first) {
    v.pt = get3(e.pt, i);
    v.n = get3(e.n, i);
    v.beta = get3(e.beta, i);
    v.pdf_fwd = e.pdf[i];
    v.valid = true;
    v.is_delta = false;
  } else {
    v = load_vertex(lb, j - 1, i);
  }
  if (!v.valid || v.is_delta) return;
  const float ptv[3] = {v.pt.x, v.pt.y, v.pt.z};
  float rx, ry;
  if (!world_to_raster(p.cam, ptv, rx, ry)) return;

  const V3 cam_o = v3(p.cam.origin[0], p.cam.origin[1], p.cam.origin[2]);
  const V3 to_cam = sub(cam_o, v.pt);
  const float dist = sqrtf(fmaxf(length_sq(to_cam), 1e-20f));
  const V3 to_cam_u = v3(to_cam.x / dist, to_cam.y / dist, to_cam.z / dist);
  const V3 origin = add(v.pt, scale(v.n, kRayEps));
  const Trace8 sh = trace_ray<kEngine, true>(
      sc, origin.x, origin.y, origin.z, to_cam_u.x, to_cam_u.y, to_cam_u.z,
      dist - kRayEps, -1, true);
  if (rows != nullptr) atomicAdd(rows + i, sh.rows);
  if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f)) return;
  const float cos_light = dot(v.n, to_cam_u);
  const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
  const float cos_cam = fabsf(dot(fwd, neg(to_cam_u)));
  if (!(cos_light > kEps)) return;

  const Frame fr = frame(v.n);
  const V3 to_cam_local = to_local(to_cam_u, fr);
  const float d2 = fmaxf(length_sq(to_cam), kRayEps);
  const float pdf_trace_cam = cos_light / (d2 * p.plane_area * cube(cos_cam));
  V3 light_f;
  float w_light;
  if (first) {
    light_f = v3(kInvPi, kInvPi, kInvPi);
    w_light = pdf_trace_cam / fmaxf(v.pdf_fwd, 1e-20f);
  } else {
    const V3 to_prev_local = to_local(v.wo, fr);
    const BsdfEval ev = bsdf_eval<false, true>(
        surf_of(sc, v.mat_id, v.u, v.v), to_prev_local, to_cam_local, 1.0f);
    light_f = ev.f;
    const float pdf_rev_sa = ev.pdf_rev;
    const float d_vcm = p.vcm ? p.eta_vcm + v.d_vcm : v.d_vcm;
    w_light = pdf_trace_cam * (d_vcm + pdf_rev_sa * v.d_vc);
  }
  const float we = 1.0f / (p.plane_area * fourth(cos_cam));
  const float g = cos_light * cos_cam / d2;
  const V3 contrib =
      mul(scale(mul(v.beta, light_f), g * we), v3(sh.s0, sh.s1, sh.s2));
  const float weight = 1.0f / (1.0f + w_light);
  const V3 o = p.weighting(contrib, weight);
  int32_t ix, iy;
  splat_pixel(p, rx, ry, ix, iy);
  const int64_t pix = static_cast<int64_t>(iy) * p.width + ix;
  atomicAdd(fb + 3 * pix, o.x);
  atomicAdd(fb + 3 * pix + 1, o.y);
  atomicAdd(fb + 3 * pix + 2, o.z);
}

// ---- K13: the connection stage, in two kernels -----------------------------
// 1. pair_term (bdpt_pairs.cu): one thread per (eye depth t, slot, pixel
//    i). Slot 0 is s = 1 (NEE, keys fold_in(key_c, t): row t of the
//    launch's key table, nee_key_tables; the G clamp 15, a
//    shadow ray that skips the light's triangle); slot 1 + j the
//    connection s = j + 2 to stored light vertex j (four reverse pdfs, the
//    G clamp 2, a shadow ray). It traces at most one shadow ray and
//    returns the weighted contribution, or +0 where nothing was traced or
//    the ray was blocked; the kernel stores it in terms [D, S, N, 3] (D =
//    eye_depth - 1 eye depths, S = light_depth slots).
// 2. gather_pixel (bdpt_gather.cu): one thread per pixel adds, from zero,
//    the sky term of an escaped walk, then for each t in order (skipping
//    delta eye vertices, stopping at the first invalid one) s = 0 (the eye
//    walk hit a light; no ray, so it is computed here), slot 0, slots
//    1..S-1, and last the splat's frame buffer. These are the float32
//    additions of the per-pixel loop the two kernels replaced, in its
//    order; a slot that contributed nothing adds +0, which leaves a sum
//    that is never -0 unchanged, so the pixel is bit-equal.

struct ConnectParams {
  CameraParams cam;
  float plane_area;
  uint32_t key_c0, key_c1;  // key_c (the prologue folds the table)
  const KeyPair* nee_keys;  // [eye_depth + 1][3]: fold_in(key_c, t)'s
  int eye_depth, light_depth;
  bool naive, nee, connection, sample_environment;
  Weighting weighting;
};

struct ConnectIn {
  PathBufs eye, light;
  const float* ev0_pt;     // [N,3] the lens point of each eye path
  const bool* esc_valid;   // [N]
  const float* esc_d;      // [N,3]
  const float* esc_beta;   // [N,3]
  const float* fb;         // nullable: the splat, added to the result
};

struct ConnectLaunch {
  SceneRefs sc;
  ConnectParams p;
  ConnectIn in;
  const int32_t* px;
  const int32_t* py;
  float* terms;  // [D, S, N, 3]: written by the pairs, read by the gather
  float* out;    // [N, 3]: the gather's result
  int32_t* rays;
  int32_t* rows;
  int64_t n;
  int engine;
};

// Row of pair (t, slot) in terms, times N, plus the pixel.
__device__ __forceinline__ int64_t term_row(const ConnectLaunch& c, int t,
                                            int slot, int64_t i) {
  return (static_cast<int64_t>(t - 2) * c.p.light_depth + slot) * c.n + i;
}

template <int kEngine>
__device__ __forceinline__ V3 pair_term(const ConnectLaunch& c, int t,
                                        int slot, int64_t i) {
  const SceneRefs& sc = c.sc;
  const ConnectParams& p = c.p;
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  // every strategy skips invalid and delta eye vertices: leave before any
  // light vertex is fetched
  const int64_t ke = static_cast<int64_t>(t - 2) * c.in.eye.n + i;
  if (!c.in.eye.valid[ke] || unpack_flags(c.in.eye.flags[ke]).is_delta)
    return zero;
  const bool nee = slot == 0;
  if (nee ? !(p.nee && sc.lights.count > 0) : !p.connection) return zero;
  Vertex lv;
  if (!nee) {
    const int64_t kl = static_cast<int64_t>(slot - 1) * c.in.light.n + i;
    if (!c.in.light.valid[kl] ||
        unpack_flags(c.in.light.flags[kl]).is_delta)
      return zero;
    lv = load_vertex(c.in.light, slot - 1, i);
  }
  const Vertex ev = load_vertex(c.in.eye, t - 2, i);
  const Weighting& wt = p.weighting;

  if (nee) {  // s = 1
    const float num =
        static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
    const uint32_t id = static_cast<uint32_t>((c.py[i] << 14) + c.px[i]);
    atomicAdd(c.rays + i, 1);
    const RowDraws kk{p.nee_keys + kNeeKeyDraws * t, id};
    const LightPoint lp = light_point(kk, sc);
    const V3 stl = sub(lp.p, ev.pt);
    const float d2 = fmaxf(length_sq(stl), kRayEps);
    const float dist = sqrtf(d2);
    const V3 stl_u = v3(stl.x / dist, stl.y / dist, stl.z / dist);
    const V3 origin = add(ev.pt, scale(ev.n, kRayEps));
    const Trace8 sh = trace_ray<kEngine, true>(
        sc, origin.x, origin.y, origin.z, stl_u.x, stl_u.y, stl_u.z,
        dist - kEps, lp.tri, true);
    if (c.rows != nullptr) atomicAdd(c.rows + i, sh.rows);
    const float cos_light = dot(lp.n, neg(stl_u));
    if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f && cos_light >= kEps))
      return zero;
    const float cos_surf = fabsf(dot(ev.n, stl_u));
    const float g = fminf(cos_light * cos_surf / d2, kMaxGNee);
    const float pdf_connect = (1.0f / num) / fmaxf(lp.area, 1e-20f);
    const float pdf_emit_sa = cos_light / kPi;
    const Frame fe = frame(ev.n);
    const V3 ptc_local = to_local(neg(ev.wo), fe);
    const V3 stl_local = to_local(stl_u, fe);
    const BsdfEval be = bsdf_eval<true, true>(
        surf_of(sc, ev.mat_id, ev.u, ev.v), neg(ptc_local), stl_local, 1.0f);
    const V3 contrib = scale(mul(mul(v3(sh.s0, sh.s1, sh.s2), be.f), lp.le),
                             g / pdf_connect);
    const float pdf_bsdf_sa = be.pdf;
    const float pdf_bsdf_area = pdf_bsdf_sa * fabsf(cos_light) / d2;
    const float w_light = pdf_bsdf_area / fmaxf(pdf_connect, 1e-20f);
    const float pdf_curr_rev_area = pdf_emit_sa * fabsf(stl_local.z) / d2;
    const float pdf_prev_rev_sa = be.pdf_rev;
    const float w_eye =
        pdf_curr_rev_area * (ev.d_vcm + pdf_prev_rev_sa * ev.d_vc);
    const float weight = 1.0f / (1.0f + w_light + w_eye);
    return wt(mul(contrib, ev.beta), weight);
  }

  // s >= 2: the connection to stored light vertex slot - 1
  const V3 e2l = sub(lv.pt, ev.pt);
  const float d2 = fmaxf(length_sq(e2l), kRayEps);
  const float dist = sqrtf(d2);
  const V3 e2l_u = v3(e2l.x / dist, e2l.y / dist, e2l.z / dist);
  const float cos_l = fabsf(dot(lv.n, neg(e2l_u)));
  const float cos_e = fabsf(dot(ev.n, e2l_u));
  if (!(cos_l > kEps && cos_e > kEps)) return zero;
  const V3 origin = add(ev.pt, scale(ev.n, kRayEps));
  atomicAdd(c.rays + i, 1);
  const Trace8 sh = trace_ray<kEngine, true>(
      sc, origin.x, origin.y, origin.z, e2l_u.x, e2l_u.y, e2l_u.z,
      dist - kRayEps, -1, true);
  if (c.rows != nullptr) atomicAdd(c.rows + i, sh.rows);
  if (!(max3(sh.s0, sh.s1, sh.s2) > 0.0f)) return zero;

  const Frame fl = frame(lv.n), fe = frame(ev.n);
  const V3 l2e_loc_l = to_local(neg(e2l_u), fl);
  const V3 to_l_from_prev_loc = to_local(neg(lv.wo), fl);
  const V3 l2e_loc_e = to_local(neg(e2l_u), fe);
  const V3 to_prev_loc_e = to_local(ev.wo, fe);
  // one evaluation a side: f_eval(A, B) is bsdf_f(-A, B), pdf_eval(A, B)
  // bsdf_pdf(-A, B)
  const BsdfEval bl =
      bsdf_eval<true, true>(surf_of(sc, lv.mat_id, lv.u, lv.v), l2e_loc_l,
                            neg(to_l_from_prev_loc), 1.0f);
  const BsdfEval be =
      bsdf_eval<true, true>(surf_of(sc, ev.mat_id, ev.u, ev.v),
                            neg(l2e_loc_e), to_prev_loc_e, 1.0f);

  // four reverse pdfs
  const float pdf_eye_rev_sa = bl.pdf_rev;
  const float pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2;
  const float pdf_bef_eye_rev_sa = be.pdf;
  const float pdf_light_rev_sa = be.pdf_rev;
  const float pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2;
  const float pdf_bef_light_rev_sa = bl.pdf;
  const float w_eye =
      pdf_eye_rev_area * (ev.d_vcm + pdf_bef_eye_rev_sa * ev.d_vc);
  const float w_light =
      pdf_light_rev_area * (lv.d_vcm + pdf_bef_light_rev_sa * lv.d_vc);
  const float weight = 1.0f / (1.0f + w_eye + w_light);

  const V3 f_eye = be.f;
  const V3 f_light = bl.f;
  const float g = fminf(cos_e * cos_l / d2, kMaxGConnect);
  const V3 contrib =
      mul(scale(mul(mul(mul(ev.beta, lv.beta), f_eye), f_light), g),
          v3(sh.s0, sh.s1, sh.s2));
  return wt(contrib, weight);
}

__device__ __forceinline__ V3 gather_pixel(const ConnectLaunch& c,
                                           int64_t i) {
  const SceneRefs& sc = c.sc;
  const ConnectParams& p = c.p;
  const ConnectIn& in = c.in;
  const Weighting& wt = p.weighting;
  V3 li = v3(0.0f, 0.0f, 0.0f);
  if (p.sample_environment && in.esc_valid[i]) {
    const V3 e = mul(get3(in.esc_beta, i), sample_sky(get3(in.esc_d, i), true));
    li = add(li, wt(e, 1.0f));
  }
  const float num =
      static_cast<float>(sc.lights.count > 1 ? sc.lights.count : 1);
  const V3 fwd = v3(p.cam.forward[0], p.cam.forward[1], p.cam.forward[2]);
  const bool nee = p.nee && sc.lights.count > 0;
  for (int t = 2; t <= p.eye_depth; ++t) {
    const Vertex ev = load_vertex(in.eye, t - 2, i);
    if (!ev.valid) break;  // every later eye vertex is invalid too
    const bool first_t = t == 2;
    V3 prev_pt;
    bool prev_delta;
    if (first_t) {
      prev_pt = get3(in.ev0_pt, i);
      prev_delta = true;
    } else {
      const int64_t k = static_cast<int64_t>(t - 3) * in.eye.n + i;
      prev_pt = get3(in.eye.pt, k);
      prev_delta = unpack_flags(in.eye.flags[k]).is_delta;
    }
    if (ev.is_delta) continue;  // every strategy skips delta eye vertices

    // s = 0: the eye walk hit a light
    if (p.naive && ev.light_ind >= 0 && !ev.backface) {
      const float* lr =
          sc.lights.rows + 17 * static_cast<int64_t>(ev.light_ind);
      const V3 le = row_v3(lr, 12);
      const float area = __ldg(lr + 15);
      const V3 wo_n = normalize(ev.wo);
      const float cos_l = fabsf(dot(ev.n, wo_n));
      const float d2 = fmaxf(length_sq(sub(ev.pt, prev_pt)), 1e-20f);
      const float pdf_connect = (1.0f / num) / fmaxf(area, 1e-20f);
      float w_eye;
      V3 contrib = mul(le, ev.beta);
      if (first_t) {
        const float cos_cam = fabsf(dot(fwd, neg(wo_n)));
        const float pdf_trace_cam =
            cos_l / (d2 * p.plane_area * cube(cos_cam));
        w_eye = pdf_connect / fmaxf(pdf_trace_cam, 1e-20f);
      } else {
        const float pdf_c = prev_delta ? 0.0f : pdf_connect;
        w_eye = pdf_c * ev.d_vcm + pdf_c * (cos_l / kPi) * ev.d_vc;
        const float lum = luminance(contrib);
        if (lum > kMaxFireflyLum)
          contrib = scale(contrib, kMaxFireflyLum / fmaxf(lum, 1e-20f));
      }
      li = add(li, wt(contrib, 1.0f / (1.0f + w_eye)));
    }
    // s = 1, then s >= 2 in light-vertex order: the pairs' terms
    if (nee) li = add(li, get3(c.terms, term_row(c, t, 0, i)));
    if (p.connection)
      for (int s = 1; s < p.light_depth; ++s)
        li = add(li, get3(c.terms, term_row(c, t, s, i)));
  }
  if (in.fb != nullptr) li = add(li, get3(in.fb, i));
  return li;
}

// ---- host side: the C entries' argument blocks -----------------------------
// The C entry points take host arrays (ptrs: device addresses, 0 = none;
// iv: integers; fv: floats; keys: uint32 words) whose layouts are given at
// each entry in bdpt_walk.cu, bdpt_splat.cu and bdpt_pairs.cu (shared by
// bdpt_gather.cu); these unpack them.

template <class T>
inline T* dev_ptr(const int64_t* ptrs, int k) {
  return reinterpret_cast<T*>(ptrs[k]);
}

// The engine fields at the end of a launch's arrays: ptrs[kp] the
// threaded tables (0 under BVH8), iv[ki] the engine, iv[ki + 1] their
// nodes, iv[ki + 2] their slots. Returns the engine, or -1 if the fields
// are not a valid one.
inline int engine_refs(const int64_t* ptrs, int kp, const int64_t* iv,
                       int ki, SceneRefs& sc) {
  sc.bin = dev_ptr<const float>(ptrs, kp);
  sc.bin_nodes = static_cast<int32_t>(iv[ki + 1]);
  const int engine = static_cast<int>(iv[ki]);
  return engine_ok(engine, sc.bin, iv[ki + 1], iv[ki + 2]) ? engine : -1;
}

// The 11 buffer fields from ptrs[0..10].
inline PathBufs path_bufs(const int64_t* ptrs, int64_t n, int depth) {
  PathBufs b;
  b.pt = dev_ptr<float>(ptrs, 0);
  b.n_oct = dev_ptr<uint32_t>(ptrs, 1);
  b.wo_oct = dev_ptr<uint32_t>(ptrs, 2);
  b.uv = dev_ptr<__half>(ptrs, 3);
  b.beta = dev_ptr<__half>(ptrs, 4);
  b.pdf_fwd = dev_ptr<float>(ptrs, 5);
  b.d_vcm = dev_ptr<float>(ptrs, 6);
  b.d_vc = dev_ptr<float>(ptrs, 7);
  b.d_vm = dev_ptr<float>(ptrs, 8);
  b.flags = dev_ptr<uint32_t>(ptrs, 9);
  b.valid = dev_ptr<bool>(ptrs, 10);
  b.n = n;
  b.depth = depth;
  return b;
}

struct WalkLaunch {
  SceneRefs sc;
  WalkParams p;
  WalkOut out;
  const int32_t* px;
  const int32_t* py;
  int64_t n;
  int engine;
};

inline bool walk_launch(const int64_t* ptrs, const int64_t* iv,
                        const float* fv, const uint32_t* keys,
                        WalkLaunch& w) {
  w.n = iv[0];
  w.sc.table = dev_ptr<const float>(ptrs, 0);
  w.sc.tri_f32 = dev_ptr<const float>(ptrs, 1);
  w.sc.tri_cols = static_cast<int>(iv[1]);
  w.sc.lights.rows = dev_ptr<const float>(ptrs, 2);
  w.sc.lights.count = static_cast<int32_t>(iv[2]);
  w.sc.mat_f32 = dev_ptr<const float>(ptrs, 35);
  w.sc.shade = dev_ptr<const float4>(ptrs, 34);
  w.sc.textures = dev_ptr<const float>(ptrs, 3);
  w.px = dev_ptr<const int32_t>(ptrs, 4);
  w.py = dev_ptr<const int32_t>(ptrs, 5);
  WalkParams& p = w.p;
  p.cam = make_camera(fv, keys);
  p.plane_area = fv[19];
  p.eta_vcm = fv[20];
  p.key0 = keys[10];
  p.key1 = keys[11];
  p.mode = static_cast<int>(iv[3]);
  p.max_depth = static_cast<int>(iv[4]);
  p.radiance = iv[5] != 0;
  p.use_vm = iv[6] != 0;
  WalkOut& o = w.out;
  o.bufs = path_bufs(ptrs + 6, w.n, p.max_depth - 1);
  o.v0_pt = dev_ptr<float>(ptrs, 17);
  o.v0_n = dev_ptr<float>(ptrs, 18);
  o.v0_beta = dev_ptr<float>(ptrs, 19);
  o.v0_pdf = dev_ptr<float>(ptrs, 20);
  o.v0_light = dev_ptr<int32_t>(ptrs, 21);
  o.v0_mat = dev_ptr<int32_t>(ptrs, 22);
  o.v0_tri = dev_ptr<int32_t>(ptrs, 23);
  o.esc_valid = dev_ptr<bool>(ptrs, 24);
  o.esc_d = dev_ptr<float>(ptrs, 25);
  o.esc_beta = dev_ptr<float>(ptrs, 26);
  o.rays = dev_ptr<int32_t>(ptrs, 27);
  o.rows = dev_ptr<int32_t>(ptrs, 28);
  p.key_table = dev_ptr<const KeyPair>(ptrs, 29);
  w.engine = engine_refs(ptrs, 30, iv, 7, w.sc);
  o.start = dev_ptr<float>(ptrs, 33);
  return w.sc.shade != nullptr && w.sc.mat_f32 != nullptr &&
         (p.mode == kModeEye ? o.esc_valid != nullptr && o.esc_d != nullptr &&
                                   o.esc_beta != nullptr
                             : p.mode == kModeLight && o.start != nullptr) &&
         p.max_depth >= 1 && w.engine >= 0 && p.key_table != nullptr &&
         (iv[11] != 0 || w.engine == kEngineBvh8);
}

struct SplatLaunch {
  SceneRefs sc;
  SplatParams p;
  PathBufs lb;
  Endpoint e;
  float* fb;
  int32_t* rays;
  int32_t* rows;
  int64_t n;
  int64_t n_live;  // paths i >= n_live splat nothing (a mega chunk's pads)
  int engine;
  // the stages' scratch (bdpt_splat.cu): each (row, path)'s tile and rank
  // in its classify block (bin_code), the queue of the entries that trace
  // in tile order, per tile its count and its first queue slot
  // (offsets[tiles] = the queue's length), and per (classify block, tile)
  // the block's first slot inside the tile
  int32_t* tile_of;
  int32_t* queue;
  int32_t* hist;
  int32_t* offsets;
  int32_t* block_base;
  int tile, tiles_x, tiles;
  int bin_blocks;  // the classify and scatter kernels' grid
  int stages;      // 1: classify and bin; 2: trace and splat
};

inline bool splat_launch(const int64_t* ptrs, const int64_t* iv,
                         const float* fv, SplatLaunch& s) {
  static const uint32_t kNoKeys[8] = {};
  s.n = iv[0];
  s.sc.table = dev_ptr<const float>(ptrs, 0);
  s.sc.tri_f32 = dev_ptr<const float>(ptrs, 1);
  s.sc.tri_cols = static_cast<int>(iv[1]);
  s.sc.lights.rows = nullptr;
  s.sc.lights.count = 0;
  s.sc.mat_f32 = dev_ptr<const float>(ptrs, 2);
  s.sc.shade = nullptr;  // the splat reads no shading record
  s.sc.textures = dev_ptr<const float>(ptrs, 3);
  s.lb = path_bufs(ptrs + 4, s.n, static_cast<int>(iv[2]));
  s.e.pt = dev_ptr<const float>(ptrs, 15);
  s.e.n = dev_ptr<const float>(ptrs, 16);
  s.e.beta = dev_ptr<const float>(ptrs, 17);
  s.e.pdf = dev_ptr<const float>(ptrs, 18);
  s.e.mat = dev_ptr<const int32_t>(ptrs, 19);
  s.fb = dev_ptr<float>(ptrs, 20);
  s.rays = dev_ptr<int32_t>(ptrs, 21);
  s.rows = dev_ptr<int32_t>(ptrs, 22);
  s.p.cam = make_camera(fv, kNoKeys);
  s.p.plane_area = fv[19];
  s.p.width = static_cast<int>(iv[3]);
  s.p.height = static_cast<int>(iv[4]);
  s.p.weighting.do_mis = iv[5] != 0;
  s.p.weighting.paint_weight = iv[6] != 0;
  s.p.vcm = iv[7] != 0;
  s.p.eta_vcm = fv[20];
  s.n_live = iv[8];
  s.engine = engine_refs(ptrs, 23, iv, 9, s.sc);
  s.tile_of = dev_ptr<int32_t>(ptrs, 24);
  s.queue = dev_ptr<int32_t>(ptrs, 25);
  s.hist = dev_ptr<int32_t>(ptrs, 26);
  s.block_base = dev_ptr<int32_t>(ptrs, 27);
  s.tile = static_cast<int>(iv[12]);
  s.tiles_x = static_cast<int>(iv[13]);
  s.tiles = static_cast<int>(iv[14]);
  s.bin_blocks = static_cast<int>(iv[15]);
  s.stages = static_cast<int>(iv[16]);
  s.offsets = s.hist + s.tiles;
  const int tiles_y = s.tile > 0 ? (s.p.height + s.tile - 1) / s.tile : 0;
  return s.lb.depth >= 0 && s.p.width > 0 && s.p.height > 0 &&
         s.n_live >= 0 && s.n_live <= s.n && s.engine >= 0 &&
         s.tile > 0 && s.tiles_x == (s.p.width + s.tile - 1) / s.tile &&
         s.tiles == s.tiles_x * tiles_y && s.bin_blocks >= 1 &&
         (s.stages == 1 || s.stages == 2) && s.fb != nullptr &&
         s.tile_of != nullptr && s.queue != nullptr && s.hist != nullptr && s.block_base != nullptr;
}

inline bool connect_launch(const int64_t* ptrs, const int64_t* iv,
                           const float* fv, const uint32_t* keys,
                           ConnectLaunch& c) {
  static const uint32_t kNoKeys[8] = {};
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
  ConnectParams& p = c.p;
  p.cam = make_camera(fv, kNoKeys);
  p.plane_area = fv[19];
  p.key_c0 = keys[0];
  p.key_c1 = keys[1];
  p.eye_depth = static_cast<int>(iv[3]);
  p.light_depth = static_cast<int>(iv[4]);
  p.naive = iv[5] != 0;
  p.nee = iv[6] != 0;
  p.connection = iv[7] != 0;
  p.weighting.do_mis = iv[8] != 0;
  p.weighting.paint_weight = iv[9] != 0;
  p.sample_environment = iv[10] != 0;
  c.in.eye = path_bufs(ptrs + 7, c.n, p.eye_depth - 1);
  c.in.ev0_pt = dev_ptr<const float>(ptrs, 18);
  c.in.esc_valid = dev_ptr<const bool>(ptrs, 19);
  c.in.esc_d = dev_ptr<const float>(ptrs, 20);
  c.in.esc_beta = dev_ptr<const float>(ptrs, 21);
  c.in.light = path_bufs(ptrs + 22, c.n, p.light_depth - 1);
  c.in.fb = dev_ptr<const float>(ptrs, 33);
  c.out = dev_ptr<float>(ptrs, 34);
  c.rays = dev_ptr<int32_t>(ptrs, 35);
  c.rows = dev_ptr<int32_t>(ptrs, 36);
  c.engine = engine_refs(ptrs, 37, iv, 11, c.sc);
  c.terms = dev_ptr<float>(ptrs, 38);
  c.sc.shade = dev_ptr<const float4>(ptrs, 39);
  p.nee_keys = dev_ptr<const KeyPair>(ptrs, 40);
  return c.sc.shade != nullptr && p.eye_depth >= 2 && p.light_depth >= 1 &&
         c.engine >= 0 && c.terms != nullptr;
}

}  // namespace tpt
