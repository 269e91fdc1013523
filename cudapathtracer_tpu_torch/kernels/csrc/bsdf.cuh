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
// Design: each lobe is a plain function of registers; the uniforms a sample
// needs are drawn lazily through the caller's draw functor, so a lobe that
// needs two draws pays for two Threefry calls.
//
// Arithmetic follows ops/bsdf.py operation for operation (the file is built
// with -fmad=false); sqrtf and division are correctly rounded, sinf, cosf
// and expf are CUDA's (not the fast intrinsics).
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

__device__ __forceinline__ V3 resolve_albedo(const float* __restrict__ tex,
                                             const Mat& m, float u, float v) {
  if (m.tex_start < 0) return m.albedo;
  return sample_texture(tex, m.tex_start, m.tex_width, m.tex_height, u, v);
}

__device__ __forceinline__ V3 resolve_albedo(const float* __restrict__ tex,
                                             const ShadeHit& s) {
  return resolve_albedo(tex, s.mat, s.uv0, s.uv1);
}

__device__ __forceinline__ float resolve_transmission(
    const float* __restrict__ tex, const Mat& m, float u, float v) {
  if (m.trans_tex_start < 0) return m.transmission;
  return sample_texture(tex, m.trans_tex_start, m.trans_tex_width,
                        m.trans_tex_height, u, v).x;
}

__device__ __forceinline__ float resolve_transmission(
    const float* __restrict__ tex, const ShadeHit& s) {
  return resolve_transmission(tex, s.mat, s.uv0, s.uv1);
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

__device__ __forceinline__ V3 metal_f(V3 eta, V3 k, float roughness, V3 wi,
                                      V3 wo) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  const V3 h = upper(normalize(add(wi, wo)));
  const float alpha = roughness * roughness;
  const float d = d_ggx(h.z, alpha);
  const float g = g_smith(wi.z, wo.z, alpha);
  const float c = dot(wi, h);
  const float denom = fmaxf(4.0f * wi.z * wo.z, kEps);
  const float dg = d * g / denom;
  return v3(dg * fresnel_conductor1(c, eta.x, k.x),
            dg * fresnel_conductor1(c, eta.y, k.y),
            dg * fresnel_conductor1(c, eta.z, k.z));
}

// D * h.z / (4 dot(wo, h)), the denominator's magnitude clamped.
__device__ __forceinline__ float metal_pdf(float roughness, V3 wi, V3 wo) {
  const V3 h = normalize(add(wi, wo));
  const float d = d_ggx(h.z, roughness * roughness);
  const float denom = 4.0f * dot(wo, h);
  const float sign = denom >= 0.0f ? 1.0f : -1.0f;
  return d * h.z / (sign * fmaxf(fabsf(denom), 1e-8f));
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

__device__ __forceinline__ V3 leaf_f(V3 albedo, float ior, float curr_ior,
                                     float roughness, float transmission,
                                     V3 wi, V3 wo) {
  const V3 diffuse = scale(albedo, kInvPi);
  if (wo.z * wi.z > 0.0f) {
    const V3 h = upper(normalize(add(wi, wo)));
    const float mf = fresnel_schlick(dot(wi, h), curr_ior, ior);
    const float alpha = roughness * roughness;
    const float d = d_ggx(h.z, alpha);
    const float g = g_smith(wi.z, wo.z, alpha);
    const float denom = fmaxf(4.0f * wi.z * wo.z, kEps);
    const float cuticle = d * g * mf / denom;
    const float w = (1.0f - mf) * (1.0f - transmission);
    return v3(w * diffuse.x + cuticle, w * diffuse.y + cuticle,
              w * diffuse.z + cuticle);
  }
  const float fres = fresnel_schlick(wi.z, curr_ior, ior);
  return scale(diffuse, transmission * (1.0f - fres));
}

__device__ __forceinline__ float leaf_pdf(float ior, float curr_ior,
                                          float roughness, float transmission,
                                          V3 wi, V3 wo) {
  float fres = fresnel_schlick(fabsf(wi.z), curr_ior, ior);
  fres = fminf(fres, 1.0f - 0.1f * roughness);
  if (wo.z * wi.z > 0.0f) {
    const float p_spec = fres;
    const float p_diff_refl = (1.0f - fres) * (1.0f - transmission);
    return p_spec * metal_pdf(roughness, wi, wo) +
           p_diff_refl * cosine_pdf(wo);
  }
  const float p_diff_trans = (1.0f - fres) * transmission;
  return cosine_pdf(neg(wo)) * p_diff_trans;
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

__device__ __forceinline__ V3 bsdf_f(const Mat& m, V3 albedo, V3 wi, V3 wo,
                                     float eta_i, float transmission) {
  switch (m.type) {
    case kMatDiffuse:
      return scale(albedo, kInvPi);
    case kMatMetal:
      return metal_f(m.eta, m.k, m.roughness, wi, wo);
    case kMatLeaf:
      return leaf_f(albedo, m.ior, eta_i, m.roughness, transmission, wi, wo);
    case kMatDeltaMirror: {
      const float f = mirror_f(wo);
      return v3(f, f, f);
    }
    default:  // smooth dielectric: a delta lobe, f = 0
      return v3(0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ float bsdf_pdf(const Mat& m, V3 wi, V3 wo,
                                          float eta_i, float transmission) {
  switch (m.type) {
    case kMatDiffuse:
      return cosine_pdf(wo);
    case kMatMetal:
      return metal_pdf(m.roughness, wi, wo);
    case kMatLeaf:
      return leaf_pdf(m.ior, eta_i, m.roughness, transmission, wi, wo);
    case kMatDeltaMirror:
      return 1.0f;
    default:
      return 0.0f;
  }
}

// Sample wo for one path; draw(k) returns the uniform of draw base + k
// (0: u_sel, 1: u_t, 2: u1, 3: u2). Types without a lobe of their own
// sample the Lambertian lobe, as the plain dispatch's default does.
// radiance: false for importance transport (the BDPT light walk).
template <class Draw>
__device__ __forceinline__ Sample bsdf_sample(const Draw& draw, const Mat& m,
                                              V3 albedo, V3 wi, bool backface,
                                              float eta_i, float transmission,
                                              bool radiance = true) {
  switch (m.type) {
    case kMatMetal: {
      const V3 h = ggx_sample_h(draw(2), draw(3), m.roughness * m.roughness);
      V3 wo = sub(scale(h, 2.0f * dot(wi, h)), wi);
      if (wo.z <= 0.0f) wo.z = -wo.z;
      Sample s;
      s.wo = wo;
      s.f = metal_f(m.eta, m.k, m.roughness, wi, wo);
      s.pdf = metal_pdf(m.roughness, wi, wo);
      return s;
    }
    case kMatSmoothDielectric:
      return dielectric_sample(draw(0), wi, m.ior, backface, radiance);
    case kMatLeaf:
      return leaf_sample(draw(0), draw(1), draw(2), draw(3), wi, m.ior,
                         eta_i, m.roughness, albedo, transmission);
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
      s.f = scale(albedo, kInvPi);
      s.pdf = cosine_pdf(s.wo);
      return s;
    }
  }
}

}  // namespace tpt
