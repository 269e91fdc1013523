// K8-K10 device code of the photon grid: the half2 codec and the 32-byte
// photon row (K10), the cell hash and sort key (K8), and the bounded
// 8-cell merge query (K9).
//
// Replaces cudapathtracer_tpu/utils/packing.py:pack_half2 (102) and
// unpack_half2 (115), ops/hashgrid.py:pack_photons (119), photon_fields
// (130), _cell_of (142), _hash_cells (146), the key of build_grid (151) and
// fold_neighbors (240) with _window_weight and one_brick_active. The grid
// kernels (photon_grid.cu) pack, hash and index the photons; the VCM eye
// kernel (vcm_eye.cu) folds each eye vertex's candidates through
// fold_neighbors below.
//
// The merge keeps the JAX candidate set and fold order, not its TPU
// mechanics (bricks, rotates, batched gathers): cells c = 0..7 (bit 0 steps
// x, bit 1 y, bit 2 z toward the nearer half of the query's cell), then the
// cell's photons start .. start + kept - 1 in ascending index, each tested
// with the exact d^2 <= r^2. kept = min(count, cap), and in the one-brick
// mode also <= 8 - (start & 7); the weight is count / kept (1 without
// reweighting), and count - kept photons per active query are counted as
// dropped.
//
// Integer parity: the hash multiplies in uint32 (the JAX package's int32
// wraps; signed overflow is undefined in C++), the key is uint32 and wraps
// for tables above 2^24 buckets as there; the cell is floor of a true
// division (the files are built without fast math). Bound: one 8-byte
// (start, end) read and up to cap 32-byte row reads per cell, scattered,
// so memory latency.
#pragma once

#include <cuda_fp16.h>

#include <cstdint>

#include "packing.cuh"
#include "shade.cuh"

namespace tpt {

constexpr uint32_t kP1 = 73856093u, kP2 = 19349663u, kP3 = 83492791u;
constexpr int kPhotonRow = 8;  // pos 0:3, wi oct 3, beta r|g 4, b|0 5,
                               // d_vcm 6, d_vm 7

// ---- K10: half2 and the photon row -------------------------------------

__device__ __forceinline__ uint32_t pack_half2(float a, float b) {
  const uint32_t lo = __half_as_ushort(__float2half_rn(a));
  const uint32_t hi = __half_as_ushort(__float2half_rn(b));
  return lo | (hi << 16);
}

__device__ __forceinline__ float half_lo(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<uint16_t>(u & 0xFFFFu)));
}

__device__ __forceinline__ float half_hi(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<uint16_t>(u >> 16)));
}

struct Photon {
  V3 pos, wi, beta;
  float d_vcm, d_vm;
};

__device__ __forceinline__ Photon photon_fields(const float* row) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  Photon p;
  p.pos = v3(a.x, a.y, a.z);
  p.wi = unpack_oct(__float_as_uint(a.w));
  const uint32_t rg = __float_as_uint(b.x), bz = __float_as_uint(b.y);
  p.beta = v3(half_lo(rg), half_hi(rg), half_lo(bz));
  p.d_vcm = b.z;
  p.d_vm = b.w;
  return p;
}

// ---- K8: the cell, its bucket and the sort key ---------------------------

struct GridGeom {
  float smin[3];
  float cell_size;
  uint32_t table_size;
};

__device__ __forceinline__ float cell_coord(const GridGeom& g, V3 p, int k) {
  const float c = k == 0 ? p.x : (k == 1 ? p.y : p.z);
  return (c - g.smin[k]) / g.cell_size;
}

__device__ __forceinline__ uint32_t hash_cell(int32_t x, int32_t y,
                                              int32_t z, uint32_t table) {
  const uint32_t h = (static_cast<uint32_t>(x) * kP1) ^
                     (static_cast<uint32_t>(y) * kP2) ^
                     (static_cast<uint32_t>(z) * kP3);
  return h % table;
}

__device__ __forceinline__ uint32_t bucket_of(const GridGeom& g, V3 p) {
  return hash_cell(static_cast<int32_t>(floorf(cell_coord(g, p, 0))),
                   static_cast<int32_t>(floorf(cell_coord(g, p, 1))),
                   static_cast<int32_t>(floorf(cell_coord(g, p, 2))),
                   g.table_size);
}

// The salted key of photon idx in bucket h (uint32 arithmetic throughout).
__device__ __forceinline__ uint32_t salted_key(uint32_t h, uint32_t idx,
                                               uint32_t salt) {
  const uint32_t r = ((idx * 2654435761u) ^ salt) * 2246822519u;
  return h * 256u + (r >> 24);
}

// ---- K9: the merge query -------------------------------------------------

struct GridRefs {
  const float* rows;       // [P8, 8] sorted photon rows; null: no merge
  const int32_t* cell_se;  // [T+1, 2] (start, end)
  GridGeom geom;
  float r2;                // merge radius squared (float32)
  int cap;                 // max_per_cell
  bool one_brick, reweight;
};

// Folds fold(photon, w) over the in-range candidates of query q, in the
// JAX order; returns the photons the cap left out (count - kept, summed).
template <class Fold>
__device__ __forceinline__ int32_t fold_neighbors(const GridRefs& g, V3 q,
                                                  Fold&& fold) {
  int32_t base[3], step[3];
  for (int k = 0; k < 3; ++k) {
    const float c = cell_coord(g.geom, q, k);
    base[k] = static_cast<int32_t>(floorf(c));
    step[k] = c - static_cast<float>(base[k]) >= 0.5f ? 1 : -1;
  }
  int32_t dropped = 0;
  for (int c = 0; c < 8; ++c) {
    const uint32_t h =
        hash_cell(base[0] + ((c & 1) ? step[0] : 0),
                  base[1] + ((c & 2) ? step[1] : 0),
                  base[2] + ((c & 4) ? step[2] : 0), g.geom.table_size);
    const int32_t start = g.cell_se[2 * static_cast<int64_t>(h)];
    const int32_t end = g.cell_se[2 * static_cast<int64_t>(h) + 1];
    const int32_t count = end - start > 0 ? end - start : 0;
    int32_t kept = count < g.cap ? count : g.cap;
    if (g.one_brick && kept > 8 - (start & 7)) kept = 8 - (start & 7);
    const float w = g.reweight ? static_cast<float>(count) /
                                     static_cast<float>(kept > 1 ? kept : 1)
                               : 1.0f;
    for (int32_t k = 0; k < kept; ++k) {
      const float* row = g.rows + kPhotonRow * static_cast<int64_t>(start + k);
      const float4 a = *reinterpret_cast<const float4*>(row);
      if (length_sq(sub(q, v3(a.x, a.y, a.z))) <= g.r2)
        fold(photon_fields(row), w);
    }
    dropped += count - kept;
  }
  return dropped;
}

}  // namespace tpt
