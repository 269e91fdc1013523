// K3 device code: texture lookups, the five BSDF lobes and their dispatch.
//
// Replaces cudapathtracer_tpu/ops/lanemajor.py:188-498 (sample_textureT,
// resolve_albedoT, resolve_transmissionT, the lobes at 235-388, bsdf_fT
// 392, bsdf_pdfT 410, bsdf_sampleT 427) and their row-major twins in
// ops/bsdf.py. The JAX versions evaluate every lobe on every lane and select
// by material type; here a switch on the type runs the one lobe a path's
// material has. The quirks docs/PARITY.md §2.4 lists are kept: Rs-only
// conductor Fresnel, Schlick dielectric Fresnel with a forced mirror on TIR
// or F >= 0.99999, the EPS-clamped cosine pdf, the adjoint eta^2 in radiance
// mode only, and the leaf's 3-event sample. Both transport modes are here:
// radiance (the eye side) and importance (the BDPT light walk,
// models/paths.py), which differ only in the refracted dielectric's eta^2.
//
// Bound: arithmetic (a few hundred flops per lobe, a handful of
// transcendentals) plus, for textured materials, four scattered 12-byte
// texel reads; per path it is small beside the traversal.
// Design: each lobe is a plain function of registers. The material is a
// Surf (its row of mat_f32 and the hit's uv), read field by field after the
// switch on its type, so a hit carries two words of it and each lobe loads
// only the fields it reads; the texture lookups run in the lobes that read
// albedo or transmission (diffuse, leaf). A SurfHeld holds the fields in
// registers instead (a vertex evaluated against many directions, as a
// merge query's photons). bsdf_eval is one evaluation of f(wi, wo) and the
// pdfs of both directions that shares the half vector and D between them
// (the merge term, NEE and the connections take all three). The uniforms
// a sample needs are drawn lazily through the caller's draw functor, so a
// lobe that needs two draws pays for two Threefry calls.
//
// Arithmetic follows ops/bsdf.py operation for operation (the file is built
// with -fmad=false); sqrtf and division are correctly rounded, sinf, cosf
// and expf are CUDA's (not the fast intrinsics). A shared term is the value
// each separate function computes by the same operations, so bsdf_eval
// equals bsdf_f and bsdf_pdf bit for bit.
#pragma once

#include <cstdint>

#include "shade.cuh"

namespace tpt {

constexpr int32_t kMatDiffuse = 0;
constexpr int32_t kMatMetal = 1;
constexpr int32_t kMatSmoothDielectric = 2;
constexpr int32_t kMatLeaf = 4;
constexpr int32_t kMatDeltaMirror = 6;

// ---- textures -------------------------------------------------------------

__device__ __forceinline__ int32_t wrap(int32_t a, int32_t n) {
  const int32_t r = a % n;
  return r < 0 ? r + n : r;  // torch.remainder: the sign of the divisor
}

// Bilinear, wrap addressing, flat [A,3] atlas.
__device__ __forceinline__ V3 sample_texture(const float* __restrict__ tex,
                                             int32_t start, int32_t width,
                                             int32_t height, float u,
                                             float v) {
  const int32_t w = width > 1 ? width : 1;
  const int32_t h = height > 1 ? height : 1;
  const float fx = u * static_cast<float>(w) - 0.5f;
  const float fy = v * static_cast<float>(h) - 0.5f;
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  const float sx = fx - x0f;
  const float sy = fy - y0f;
  const int32_t x0 = wrap(static_cast<int32_t>(x0f), w);
  const int32_t y0 = wrap(static_cast<int32_t>(y0f), h);
  const int32_t x1 = wrap(x0 + 1, w);
  const int32_t y1 = wrap(y0 + 1, h);
  const int64_t base = start > 0 ? start : 0;
  const float* c00 = tex + 3 * (base + y0 * w + x0);
  const float* c10 = tex + 3 * (base + y0 * w + x1);
  const float* c01 = tex + 3 * (base + y1 * w + x0);
  const float* c11 = tex + 3 * (base + y1 * w + x1);
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bottom = __ldg(c00 + k) * (1.0f - sx) + __ldg(c10 + k) * sx;
    const float top = __ldg(c01 + k) * (1.0f - sx) + __ldg(c11 + k) * sx;
    out[k] = bottom * (1.0f - sy) + top * sy;
  }
  return v3(out[0], out[1], out[2]);
}

// The material of a hit or a stored vertex: its row of mat_f32 (fields in
// the layout of scene/scene.py mat_f32: type 0, albedo 1:4, roughness 4,
// eta 5:8, k 8:11, ior 11, transmission 12, is_specular 13, boundary 14,
// priority 19, tex start/w/h 20:23, trans_tex start/w/h 23:26), read at
// each use, and its uv, at which albedo() and trans() look its textures up.
struct Surf {
  const float* m;    // mat_f32 + 26 * mat_id
  const float* tex;  // the texture atlas [A, 3]
  float u, v;
  __device__ __forceinline__ int32_t type() const { return row_i32(m, 0); }
  __device__ __forceinline__ float roughness() const { return __ldg(m + 4); }
  __device__ __forceinline__ V3 eta() const { return row_v3(m, 5); }
  __device__ __forceinline__ V3 k() const { return row_v3(m, 8); }
  __device__ __forceinline__ float ior() const { return __ldg(m + 11); }
  __device__ __forceinline__ bool is_specular() const {
    return row_i32(m, 13) != 0;
  }
  __device__ __forceinline__ bool boundary() const {
    return row_i32(m, 14) != 0;
  }
  __device__ __forceinline__ int32_t priority() const {
    return row_i32(m, 19);
  }
  // resolve_albedo: the albedo map at (u, v), else the constant
  __device__ __forceinline__ V3 albedo() const {
    const int32_t start = row_i32(m, 20);
    if (start < 0) return row_v3(m, 1);
    return sample_texture(tex, start, row_i32(m, 21), row_i32(m, 22), u, v);
  }
  // resolve_transmission: the map's red channel, else the constant
  __device__ __forceinline__ float trans() const {
    const int32_t start = row_i32(m, 23);
    if (start < 0) return __ldg(m + 12);
    return sample_texture(tex, start, row_i32(m, 24), row_i32(m, 25), u, v)
        .x;
  }
};

__device__ __forceinline__ Surf surf(const float* mat_f32,
                                     const float* tex, int32_t mat_id,
                                     float u, float v) {
  Surf s;
  s.m = mat_f32 + kMatCols * static_cast<int64_t>(mat_id);
  s.tex = tex;
  s.u = u;
  s.v = v;
  return s;
}

// The fields a lobe reads, in registers, with albedo and transmission
// already resolved (the eye passes' records hold them).
struct SurfHeld {
  int32_t type_;
  float roughness_, ior_, trans_;
  V3 eta_, k_, albedo_;
  __device__ __forceinline__ int32_t type() const { return type_; }
  __device__ __forceinline__ float roughness() const { return roughness_; }
  __device__ __forceinline__ V3 eta() const { return eta_; }
  __device__ __forceinline__ V3 k() const { return k_; }
  __device__ __forceinline__ float ior() const { return ior_; }
  __device__ __forceinline__ V3 albedo() const { return albedo_; }
  __device__ __forceinline__ float trans() const { return trans_; }
};

// A hit's lobe fields, read once from its row (one batch of L1 loads, not
// one a use) for the event's evaluations, which all come before its shadow
// ray, so nothing of them lives across it. The texture lookups run only
// for lobes that read albedo (diffuse, leaf, the default's Lambertian
// sample) or transmission (leaf), or with all (the eye passes' records
// store both).
__device__ __forceinline__ SurfHeld hold(const Surf& s, bool all = false) {
  SurfHeld h;
  h.type_ = s.type();
  h.roughness_ = s.roughness();
  h.eta_ = s.eta();
  h.k_ = s.k();
  h.ior_ = s.ior();
  const bool albedo = all || (h.type_ != kMatMetal &&
                              h.type_ != kMatSmoothDielectric &&
                              h.type_ != kMatDeltaMirror);
  h.albedo_ = albedo ? s.albedo() : v3(0.0f, 0.0f, 0.0f);
  h.trans_ = all || h.type_ == kMatLeaf ? s.trans() : 0.0f;
  return h;
}

__device__ __forceinline__ SurfHeld surf_held(const float* mat_f32,
                                              int32_t mat_id, V3 albedo,
                                              float trans) {
  const float* m = mat_f32 + kMatCols * static_cast<int64_t>(mat_id);
  SurfHeld s;
  s.type_ = row_i32(m, 0);
  s.roughness_ = __ldg(m + 4);
  s.eta_ = row_v3(m, 5);
  s.k_ = row_v3(m, 8);
  s.ior_ = __ldg(m + 11);
  s.albedo_ = albedo;
  s.trans_ = trans;
  return s;
}

// ---- Fresnel --------------------------------------------------------------

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float fresnel_schlick(float cos_theta, float eta_i,
                                                 float eta_t) {
  float r0 = (eta_i - eta_t) / (eta_i + eta_t);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * pow5(1.0f - fabsf(cos_theta));
}

// s-polarized conductor Fresnel only (reference quirk), per channel.
__device__ __forceinline__ float fresnel_conductor1(float cos_theta,
                                                    float eta, float k) {
  const float c2 = cos_theta * cos_theta;
  const float s2 = 1.0f - c2;
  const float eta2 = eta * eta, k2 = k * k;
  const float t0 = eta2 - k2 - s2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * eta2 * k2, 0.0f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * cos_theta * a;
  return (t1 - t2) / (t1 + t2);
}

// ---- Lambertian -----------------------------------------------------------

__device__ __forceinline__ float cosine_pdf(V3 wo) {
  return fmaxf(wo.z, kEps) * kInvPi;
}

__device__ __forceinline__ V3 cosine_sample(float u1, float u2) {
  u1 = fminf(u1, 0.99999f);  // 1 - EPSILON
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  return v3(r * cosf(phi), r * sinf(phi), sqrtf(1.0f - u1));
}

// ---- GGX microfacet -------------------------------------------------------

__device__ __forceinline__ float d_ggx(float h_z, float alpha) {
  const float a2 = alpha * alpha;
  const float denom = h_z * h_z * (a2 - 1.0f) + 1.0f;
  return a2 / (kPi * denom * denom);
}

__device__ __forceinline__ float g1_ggx(float v_z, float alpha) {
  v_z = fmaxf(fabsf(v_z), 1e-6f);
  const float tan_t = sqrtf(fmaxf(1.0f - v_z * v_z, 0.0f)) / v_z;
  const float a = 1.0f / fmaxf(alpha * tan_t, 1e-8f);
  const float approx = (3.535f * a + 2.181f * a * a) /
                       (1.0f + 2.276f * a + 2.577f * a * a);
  return a < 1.6f ? approx : 1.0f;
}

__device__ __forceinline__ float g_smith(float wi_z, float wo_z, float alpha) {
  return g1_ggx(wi_z, alpha) * g1_ggx(wo_z, alpha);
}

__device__ __forceinline__ V3 ggx_sample_h(float u1, float u2, float alpha) {
  const float phi = kTwoPi * u2;
  const float cos_t = sqrtf(
      fmaxf((1.0f - u1) / (1.0f + (alpha * alpha - 1.0f) * u1), 0.0f));
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  return v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
}

__device__ __forceinline__ V3 upper(V3 h) { return h.z <= 0.0f ? neg(h) : h; }

// The half vector normalize(wi + wo) and its GGX D at alpha = roughness^2:
// the terms f and both pdfs of one direction pair share (D of upper(h)
// equals D of h: d_ggx reads h.z squared).
struct HalfD {
  V3 hn;
  float d;
};

__device__ __forceinline__ HalfD half_d(V3 wi, V3 wo, float roughness) {
  HalfD x;
  x.hn = normalize(add(wi, wo));
  x.d = d_ggx(x.hn.z, roughness * roughness);
  return x;
}

__device__ __forceinline__ V3 metal_f_hd(V3 eta, V3 k, float roughness, V3 wi,
                                         V3 wo, const HalfD& x) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  const V3 h = upper(x.hn);
  const float alpha = roughness * roughness;
  const float g = g_smith(wi.z, wo.z, alpha);
  const float c = dot(wi, h);
  const float denom = fmaxf(4.0f * wi.z * wo.z, kEps);
  const float dg = x.d * g / denom;
  return v3(dg * fresnel_conductor1(c, eta.x, k.x),
            dg * fresnel_conductor1(c, eta.y, k.y),
            dg * fresnel_conductor1(c, eta.z, k.z));
}

__device__ __forceinline__ V3 metal_f(V3 eta, V3 k, float roughness, V3 wi,
                                      V3 wo) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  return metal_f_hd(eta, k, roughness, wi, wo, half_d(wi, wo, roughness));
}

// D * h.z / (4 dot(wo, h)), the denominator's magnitude clamped; the pdf
// of the reverse pair (wo, wi) is metal_pdf_hd(x, wi) (the same h).
__device__ __forceinline__ float metal_pdf_hd(const HalfD& x, V3 wo) {
  const float denom = 4.0f * dot(wo, x.hn);
  const float sign = denom >= 0.0f ? 1.0f : -1.0f;
  return x.d * x.hn.z / (sign * fmaxf(fabsf(denom), 1e-8f));
}

__device__ __forceinline__ float metal_pdf(float roughness, V3 wi, V3 wo) {
  return metal_pdf_hd(half_d(wi, wo, roughness), wo);
}

__device__ __forceinline__ float mirror_f(V3 wo) {
  return 1.0f / fmaxf(wo.z, kEps);
}

// ---- smooth dielectric (delta lobe: sample only) ---------------------------

struct Sample {
  V3 wo, f;
  float pdf;
};

// radiance: the adjoint eta^2 on refraction (radiance transport); without
// it, importance transport.
__device__ __forceinline__ Sample dielectric_sample(float u, V3 wi, float ior,
                                                    bool backface,
                                                    bool radiance) {
  const float eta_i = backface ? ior : 1.0f;
  const float eta_t = backface ? 1.0f : ior;
  const float cos_i = fminf(fmaxf(wi.z, kEps), 1.0f);
  const float eta = eta_i / eta_t;
  const float cos_t2 = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const float fres = fresnel_schlick(cos_i, eta_i, eta_t);
  const bool force_reflect = (cos_t2 < 0.0f) || (fres >= 0.99999f);
  const bool reflect = force_reflect || (u < fres);
  Sample s;
  float f;
  if (reflect) {
    s.wo = v3(-wi.x, -wi.y, wi.z);
    f = (force_reflect ? 1.0f : fres) / fmaxf(s.wo.z, kEps);
    s.pdf = force_reflect ? 1.0f : fres;
  } else {
    s.wo = v3(-eta * wi.x, -eta * wi.y, -sqrtf(fmaxf(cos_t2, 0.0f)));
    f = (1.0f - fres) / fmaxf(fabsf(s.wo.z), kEps);
    if (radiance) f = f * eta * eta;  // adjoint factor
    s.pdf = 1.0f - fres;
  }
  s.f = v3(f, f, f);
  return s;
}

// ---- layered leaf ---------------------------------------------------------

// x: half_d(wi, wo, roughness), read only when wo and wi lie on one side.
__device__ __forceinline__ V3 leaf_f_hd(V3 albedo, float ior, float curr_ior,
                                        float roughness, float transmission,
                                        V3 wi, V3 wo, const HalfD& x) {
  const V3 diffuse = scale(albedo, kInvPi);
  if (wo.z * wi.z > 0.0f) {
    const V3 h = upper(x.hn);
    const float mf = fresnel_schlick(dot(wi, h), curr_ior, ior);
    const float alpha = roughness * roughness;
    const float g = g_smith(wi.z, wo.z, alpha);
    const float denom = fmaxf(4.0f * wi.z * wo.z, kEps);
    const float cuticle = x.d * g * mf / denom;
    const float w = (1.0f - mf) * (1.0f - transmission);
    return v3(w * diffuse.x + cuticle, w * diffuse.y + cuticle,
              w * diffuse.z + cuticle);
  }
  const float fres = fresnel_schlick(wi.z, curr_ior, ior);
  return scale(diffuse, transmission * (1.0f - fres));
}

__device__ __forceinline__ float leaf_pdf_hd(float ior, float curr_ior,
                                             float roughness,
                                             float transmission, V3 wi, V3 wo,
                                             const HalfD& x) {
  float fres = fresnel_schlick(fabsf(wi.z), curr_ior, ior);
  fres = fminf(fres, 1.0f - 0.1f * roughness);
  if (wo.z * wi.z > 0.0f) {
    const float p_spec = fres;
    const float p_diff_refl = (1.0f - fres) * (1.0f - transmission);
    return p_spec * metal_pdf_hd(x, wo) + p_diff_refl * cosine_pdf(wo);
  }
  const float p_diff_trans = (1.0f - fres) * transmission;
  return cosine_pdf(neg(wo)) * p_diff_trans;
}

// half_d where a leaf lobe reads it (wo and wi on one side), else unused.
__device__ __forceinline__ HalfD leaf_half_d(V3 wi, V3 wo, float roughness) {
  if (wo.z * wi.z > 0.0f) return half_d(wi, wo, roughness);
  HalfD x;
  x.hn = v3(0.0f, 0.0f, 1.0f);
  x.d = 0.0f;
  return x;
}

__device__ __forceinline__ V3 leaf_f(V3 albedo, float ior, float curr_ior,
                                     float roughness, float transmission,
                                     V3 wi, V3 wo) {
  return leaf_f_hd(albedo, ior, curr_ior, roughness, transmission, wi, wo,
                   leaf_half_d(wi, wo, roughness));
}

__device__ __forceinline__ float leaf_pdf(float ior, float curr_ior,
                                          float roughness, float transmission,
                                          V3 wi, V3 wo) {
  return leaf_pdf_hd(ior, curr_ior, roughness, transmission, wi, wo,
                     leaf_half_d(wi, wo, roughness));
}

__device__ __forceinline__ Sample leaf_sample(float u_sel, float u_t,
                                              float u1, float u2, V3 wi,
                                              float ior, float curr_ior,
                                              float roughness, V3 albedo,
                                              float transmission) {
  const float fres = fresnel_schlick(wi.z, curr_ior, ior);
  Sample s;
  if (u_sel < fres) {
    const V3 h = ggx_sample_h(u1, u2, roughness * roughness);
    s.wo = sub(scale(h, 2.0f * dot(wi, h)), wi);
  } else {
    s.wo = cosine_sample(u1, u2);
    if (u_t < transmission) s.wo.z = -s.wo.z;
  }
  s.f = leaf_f(albedo, ior, curr_ior, roughness, transmission, wi, s.wo);
  s.pdf = leaf_pdf(ior, curr_ior, roughness, transmission, wi, s.wo);
  return s;
}

// ---- dispatch -------------------------------------------------------------

// S: Surf or SurfHeld.
template <class S>
__device__ __forceinline__ V3 bsdf_f(const S& m, V3 wi, V3 wo, float eta_i) {
  switch (m.type()) {
    case kMatDiffuse:
      return scale(m.albedo(), kInvPi);
    case kMatMetal:
      return metal_f(m.eta(), m.k(), m.roughness(), wi, wo);
    case kMatLeaf:
      return leaf_f(m.albedo(), m.ior(), eta_i, m.roughness(), m.trans(), wi,
                    wo);
    case kMatDeltaMirror: {
      const float f = mirror_f(wo);
      return v3(f, f, f);
    }
    default:  // smooth dielectric: a delta lobe, f = 0
      return v3(0.0f, 0.0f, 0.0f);
  }
}

template <class S>
__device__ __forceinline__ float bsdf_pdf(const S& m, V3 wi, V3 wo,
                                          float eta_i) {
  switch (m.type()) {
    case kMatDiffuse:
      return cosine_pdf(wo);
    case kMatMetal:
      return metal_pdf(m.roughness(), wi, wo);
    case kMatLeaf:
      return leaf_pdf(m.ior(), eta_i, m.roughness(), m.trans(), wi, wo);
    case kMatDeltaMirror:
      return 1.0f;
    default:
      return 0.0f;
  }
}

// f(wi, wo), pdf(wi, wo) (with kFwd) and pdf(wo, wi) (with kRev) of one
// lobe in one evaluation: bsdf_f, bsdf_pdf(wi, wo) and bsdf_pdf(wo, wi)
// bit for bit, the half vector, D and the lobe's fields read once.
struct BsdfEval {
  V3 f;
  float pdf, pdf_rev;
};

template <bool kFwd, bool kRev, class S>
__device__ __forceinline__ BsdfEval bsdf_eval(const S& m, V3 wi, V3 wo,
                                              float eta_i) {
  BsdfEval e;
  e.f = v3(0.0f, 0.0f, 0.0f);
  e.pdf = e.pdf_rev = 0.0f;
  switch (m.type()) {
    case kMatDiffuse:
      e.f = scale(m.albedo(), kInvPi);
      if (kFwd) e.pdf = cosine_pdf(wo);
      if (kRev) e.pdf_rev = cosine_pdf(wi);
      break;
    case kMatMetal: {
      const float r = m.roughness();
      const HalfD x = half_d(wi, wo, r);
      e.f = metal_f_hd(m.eta(), m.k(), r, wi, wo, x);
      if (kFwd) e.pdf = metal_pdf_hd(x, wo);
      if (kRev) e.pdf_rev = metal_pdf_hd(x, wi);
      break;
    }
    case kMatLeaf: {
      const float r = m.roughness(), ior = m.ior(), tr = m.trans();
      const HalfD x = leaf_half_d(wi, wo, r);
      e.f = leaf_f_hd(m.albedo(), ior, eta_i, r, tr, wi, wo, x);
      if (kFwd) e.pdf = leaf_pdf_hd(ior, eta_i, r, tr, wi, wo, x);
      if (kRev) e.pdf_rev = leaf_pdf_hd(ior, eta_i, r, tr, wo, wi, x);
      break;
    }
    case kMatDeltaMirror: {
      const float f = mirror_f(wo);
      e.f = v3(f, f, f);
      e.pdf = e.pdf_rev = 1.0f;
      break;
    }
    default:
      break;
  }
  return e;
}

// Sample wo for one path; draw(k) returns the uniform of draw base + k
// (0: u_sel, 1: u_t, 2: u1, 3: u2). Types without a lobe of their own
// sample the Lambertian lobe, as the plain dispatch's default does.
// radiance: false for importance transport (the BDPT light walk).
template <class Draw, class S>
__device__ __forceinline__ Sample bsdf_sample(const Draw& draw, const S& m,
                                              V3 wi, bool backface,
                                              float eta_i,
                                              bool radiance = true) {
  switch (m.type()) {
    case kMatMetal: {
      const float r = m.roughness();
      const V3 h = ggx_sample_h(draw(2), draw(3), r * r);
      V3 wo = sub(scale(h, 2.0f * dot(wi, h)), wi);
      if (wo.z <= 0.0f) wo.z = -wo.z;
      Sample s;
      s.wo = wo;
      s.f = metal_f(m.eta(), m.k(), r, wi, wo);
      s.pdf = metal_pdf(r, wi, wo);
      return s;
    }
    case kMatSmoothDielectric:
      return dielectric_sample(draw(0), wi, m.ior(), backface, radiance);
    case kMatLeaf:
      return leaf_sample(draw(0), draw(1), draw(2), draw(3), wi, m.ior(),
                         eta_i, m.roughness(), m.albedo(), m.trans());
    case kMatDeltaMirror: {
      Sample s;
      s.wo = v3(-wi.x, -wi.y, wi.z);
      const float f = mirror_f(s.wo);
      s.f = v3(f, f, f);
      s.pdf = 1.0f;
      return s;
    }
    default: {
      Sample s;
      s.wo = cosine_sample(draw(2), draw(3));
      s.f = scale(m.albedo(), kInvPi);
      s.pdf = cosine_pdf(s.wo);
      return s;
    }
  }
}

}  // namespace tpt
