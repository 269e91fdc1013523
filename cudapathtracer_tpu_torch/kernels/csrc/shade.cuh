// K2 device code: the hit fetch (one 64-byte shading record per hit) and
// the vector math and shading frame it and K3-K5 share.
//
// Replaces cudapathtracer_tpu/ops/lanemajor.py:shade_dataT (line 125) and
// its row-major twin ops/traverse.py:shade_data: one read of the hit
// triangle's record in scene.shade_table (derived from tri_f32 at upload,
// scene/scene.py shade_table: the three vertex normals, the three uvs and
// one word of mat_id | light index << 10, as four float4s), the
// barycentric shading normal flipped to face the ray, the uv and the hit
// point o + d*t (the mega engine passes exactly that point,
// unidirectional_mega.py:356-358). What the JAX row carries besides is
// read where it is used: the material by mat_id from mat_f32 (bsdf.cuh
// Surf), and a light's emission, vertex-a normal and area by its light
// index from light_f32, whose columns 9:16 equal the triangle's (a
// non-light triangle emits nothing; tests/test_torch_scene.py holds both).
//
// Bound: one dependent 64-byte record read per hit (two sectors, four
// 16-byte loads), scattered across the table, so memory latency; the
// interpolation is ~40 flops.
// Design: the record holds only what every hit needs before its material,
// 16-byte aligned, so the fetch is four vector loads and the hit keeps 11
// words in registers; the material is read by id where the event uses it
// (bsdf.cuh Surf, hold) and a light's row only on a light. The shading
// frame (t, b, n) is built once per hit and passed to to_local / to_world.
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

// The orthonormal shading frame (t, b, n) around a unit normal n.
struct Frame {
  V3 t, b, n;
};

__device__ __forceinline__ Frame frame(V3 n) {
  Frame f;
  f.n = n;
  const bool use_x = fabsf(n.x) > fabsf(n.z);
  if (use_x) {
    const float inv_a = rsqrtf(fmaxf(n.x * n.x + n.y * n.y, 1e-20f));
    f.t = v3(-n.y * inv_a, n.x * inv_a, 0.0f);
  } else {
    const float inv_b = rsqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-20f));
    f.t = v3(0.0f, -n.z * inv_b, n.y * inv_b);
  }
  f.b = cross(n, f.t);
  return f;
}

__device__ __forceinline__ V3 to_local(V3 v, const Frame& f) {
  return v3(dot(v, f.t), dot(v, f.b), dot(v, f.n));
}

__device__ __forceinline__ V3 to_world(V3 v, const Frame& f) {
  return add(add(scale(f.t, v.x), scale(f.b, v.y)), scale(f.n, v.z));
}

// ---- the hit fetch --------------------------------------------------------

constexpr int kShadeRecord = 4;  // float4s a record of scene.shade_table
constexpr int kMatCols = 26;     // mat_f32 [M, 26]: a material's fields
constexpr int kLightCols = 17;   // light_f32 [L, 17]

struct ShadeHit {
  V3 point, normal;
  float uv0, uv1;
  int32_t mat_id, light_ind;  // light_ind -1: not a light
  bool backface;
};

__device__ __forceinline__ int32_t row_i32(const float* row, int c) {
  return __float_as_int(__ldg(row + c));
}

__device__ __forceinline__ V3 row_v3(const float* row, int c) {
  return v3(__ldg(row + c), __ldg(row + c + 1), __ldg(row + c + 2));
}

// The id word of a shading record: mat_id in bits 0-9, the light index
// (-1: none) above them.
__device__ __forceinline__ int32_t id_mat(int32_t w) { return w & 1023; }
__device__ __forceinline__ int32_t id_light(int32_t w) { return w >> 10; }

// The three vertex normals of triangle tri (its record's first 36 bytes).
__device__ __forceinline__ void vertex_normals(const float4* __restrict__ shade,
                                               int32_t tri, V3& na, V3& nb,
                                               V3& nc) {
  const float4* r = shade + kShadeRecord * static_cast<int64_t>(tri);
  const float4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
  na = v3(q0.x, q0.y, q0.z);
  nb = v3(q0.w, q1.x, q1.y);
  nc = v3(q1.z, q1.w, q2.x);
}

// The mat_id of triangle tri (its record's id word).
__device__ __forceinline__ int32_t record_mat(const float4* __restrict__ shade,
                                             int32_t tri) {
  const float* r = reinterpret_cast<const float*>(
      shade + kShadeRecord * static_cast<int64_t>(tri));
  return id_mat(__float_as_int(__ldg(r + 15)));
}

// The shading record of a closest hit (tri >= 0; a miss reads record 0, as
// the plain version's clamp does, and its record is not used).
__device__ __forceinline__ ShadeHit shade_fetch(
    const float4* __restrict__ shade, int32_t tri, float u, float v, V3 o,
    V3 d, float t) {
  const float4* r =
      shade + kShadeRecord * static_cast<int64_t>(tri > 0 ? tri : 0);
  const float4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2),
               q3 = __ldg(r + 3);
  ShadeHit s;
  const float w0 = 1.0f - u - v;
  const V3 na = v3(q0.x, q0.y, q0.z), nb = v3(q0.w, q1.x, q1.y),
           nc = v3(q1.z, q1.w, q2.x);
  V3 nrm = normalize(add(add(scale(na, w0), scale(nb, u)), scale(nc, v)));
  s.backface = dot(nrm, d) > 0.0f;
  s.normal = s.backface ? neg(nrm) : nrm;
  s.uv0 = q2.y * w0 + q2.w * u + q3.y * v;
  s.uv1 = q2.z * w0 + q3.x * u + q3.z * v;
  s.point = add(o, scale(d, t));
  const int32_t ids = __float_as_int(q3.w);
  s.mat_id = id_mat(ids);
  s.light_ind = id_light(ids);
  return s;
}

// A hit light's row of light_f32 (light_ind >= 0): emission at column 12,
// vertex-a normal at 9, area at 15.
__device__ __forceinline__ const float* light_row(const float* lights,
                                                  int32_t light_ind) {
  return lights + kLightCols * static_cast<int64_t>(light_ind);
}

// The emission of a hit: its light's, zero off the lights.
__device__ __forceinline__ V3 hit_emission(const float* lights,
                                           int32_t light_ind) {
  return light_ind >= 0 ? row_v3(light_row(lights, light_ind), 12)
                        : v3(0.0f, 0.0f, 0.0f);
}

}  // namespace tpt
