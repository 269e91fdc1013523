// K2 device code: the hit fetch (one packed shading row per hit) and the
// vector math it and K3-K5 share.
//
// Replaces cudapathtracer_tpu/ops/lanemajor.py:shade_dataT (line 125) and
// its row-major twin ops/traverse.py:shade_data (line 315): one read of the
// hit triangle's 48-float shading row (layout: scene/scene.py
// Scene.tri_shade_row, columns 28:76 of tri_f32), the barycentric shading
// normal flipped to face the ray, the uv, emission, the material fields, and
// the hit point o + d*t (the mega engine passes exactly that point,
// unidirectional_mega.py:356-358).
//
// Bound: one dependent 192-byte row read per hit, scattered across the
// triangle block, so memory latency; the interpolation is ~40 flops.
// Design: the row is read with read-only loads straight into the fields a
// shader uses, and nothing is written back: the per-path megakernel keeps
// the result in registers.
//
// Arithmetic: the vector helpers below evaluate in the order of the plain
// PyTorch versions (utils/math.py: dot products left to right, normalize as
// a * rsqrt(max(|a|^2, 1e-20))), and every including file is built with
// -fmad=false, so each product rounds before its sum as there.
#pragma once

#include <cstdint>

namespace tpt {

constexpr float kEps = 1e-5f;      // utils/math.py EPSILON
constexpr float kRayEps = 1e-4f;   // RAY_EPSILON
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;   // 2.0 * PI, rounded once
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);

// ---- vector math (utils/math.py) ------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float length_sq(V3 a) { return dot(a, a); }
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rsqrtf(fmaxf(dot(a, a), 1e-20f)));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float luminance(V3 c) {
  return c.x * 0.2126f + c.y * 0.7152f + c.z * 0.0722f;
}

// Orthonormal tangent frame (t, b) around a unit normal.
__device__ __forceinline__ void build_frame(V3 n, V3& t, V3& b) {
  const bool use_x = fabsf(n.x) > fabsf(n.z);
  if (use_x) {
    const float inv_a = rsqrtf(fmaxf(n.x * n.x + n.y * n.y, 1e-20f));
    t = v3(-n.y * inv_a, n.x * inv_a, 0.0f);
  } else {
    const float inv_b = rsqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-20f));
    t = v3(0.0f, -n.z * inv_b, n.y * inv_b);
  }
  b = cross(n, t);
}

__device__ __forceinline__ V3 to_local(V3 v, V3 n) {
  V3 t, b;
  build_frame(n, t, b);
  return v3(dot(v, t), dot(v, b), dot(v, n));
}

__device__ __forceinline__ V3 to_world(V3 v, V3 n) {
  V3 t, b;
  build_frame(n, t, b);
  return add(add(scale(t, v.x), scale(b, v.y)), scale(n, v.z));
}

// ---- the hit fetch --------------------------------------------------------

struct Mat {
  int32_t type;
  V3 albedo;
  float roughness;
  V3 eta, k;
  float ior, transmission;
  bool is_specular, boundary;
  int32_t priority;
  int32_t tex_start, tex_width, tex_height;
  int32_t trans_tex_start, trans_tex_width, trans_tex_height;
};

struct ShadeHit {
  V3 point, normal, emission, normal_a;
  float uv0, uv1, area;
  int32_t mat_id, light_ind;
  bool backface;
  Mat mat;
};

__device__ __forceinline__ int32_t row_i32(const float* row, int c) {
  return __float_as_int(__ldg(row + c));
}

__device__ __forceinline__ V3 row_v3(const float* row, int c) {
  return v3(__ldg(row + c), __ldg(row + c + 1), __ldg(row + c + 2));
}

// The material fields of one row in the layout of shade-row columns 20:46
// (scene/scene.py: a triangle's shade row from column 20, or a row of the
// per-material block mat_f32 [M, 26]).
__device__ __forceinline__ Mat read_mat(const float* r) {
  Mat m;
  m.type = row_i32(r, 0);
  m.albedo = row_v3(r, 1);
  m.roughness = __ldg(r + 4);
  m.eta = row_v3(r, 5);
  m.k = row_v3(r, 8);
  m.ior = __ldg(r + 11);
  m.transmission = __ldg(r + 12);
  m.is_specular = row_i32(r, 13) != 0;
  m.boundary = row_i32(r, 14) != 0;
  m.priority = row_i32(r, 19);
  m.tex_start = row_i32(r, 20);
  m.tex_width = row_i32(r, 21);
  m.tex_height = row_i32(r, 22);
  m.trans_tex_start = row_i32(r, 23);
  m.trans_tex_width = row_i32(r, 24);
  m.trans_tex_height = row_i32(r, 25);
  return m;
}

// The shading record of a closest hit (tri >= 0; a miss reads row 0, as the
// plain version's clamp does, and its record is not used).
__device__ __forceinline__ ShadeHit shade_fetch(const float* __restrict__ tri_f32,
                                                int tri_cols, int32_t tri,
                                                float u, float v, V3 o, V3 d,
                                                float t) {
  const float* row =
      tri_f32 + static_cast<int64_t>(tri > 0 ? tri : 0) * tri_cols + 28;
  ShadeHit s;
  const float w0 = 1.0f - u - v;
  const V3 na = row_v3(row, 0), nb = row_v3(row, 3), nc = row_v3(row, 6);
  V3 nrm = normalize(add(add(scale(na, w0), scale(nb, u)), scale(nc, v)));
  s.backface = dot(nrm, d) > 0.0f;
  s.normal = s.backface ? neg(nrm) : nrm;
  s.uv0 = __ldg(row + 9) * w0 + __ldg(row + 11) * u + __ldg(row + 13) * v;
  s.uv1 = __ldg(row + 10) * w0 + __ldg(row + 12) * u + __ldg(row + 14) * v;
  s.point = add(o, scale(d, t));
  s.emission = row_v3(row, 15);
  s.light_ind = row_i32(row, 18);
  s.mat_id = row_i32(row, 19);
  s.normal_a = na;
  s.area = __ldg(row + 46);
  s.mat = read_mat(row + 20);
  return s;
}

}  // namespace tpt
