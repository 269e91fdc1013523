// K8-K10 device code of the photon grid: the half2 codec and the 32-byte
// photon row (K10), the cell hash and sort key (K8), and the bounded
// 8-cell merge query (K9).
//
// Replaces cudapathtracer_tpu/utils/packing.py:pack_half2 (102) and
// unpack_half2 (115), ops/hashgrid.py:pack_photons (119), photon_fields
// (130), _cell_of (142), _hash_cells (146), the key of build_grid (151),
// fold_neighbors (240) with _window_weight and one_brick_active, and the
// materialised forms neighbor_slots (412), neighbor_slots_compact (512) and
// gather_neighbors (203). The grid kernels (photon_grid.cu) pack, hash and
// index the photons; the eye passes' gather (eye_gather.cu) folds each
// eye vertex's candidates through fold_neighbors below (classic pass) or
// sums them over neighbor_slots' slots (K14, cap <= 8), and
// neighbor_slots.cu materialises the three forms over a batch of queries.
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
// Design (the merge query): the 8 cells' (start, end) pairs are read up
// front, 8 independent loads, into registers (every loop over them is
// unrolled or moves the next pair down, so no index is dynamic and no cell
// table sits in local memory); a cell's candidate rows are loaded in
// batches of up to 8, all issued before the first distance test, and the
// in-range ones are folded afterwards in ascending order, so the scattered
// loads overlap instead of each waiting for the previous photon's fold.
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
  int64_t n_rows;          // P8 (the materialised forms' brick clamp)
};

// The 8 corner cells of query q (bit 0 of c steps x, bit 1 y, bit 2 z):
// (start, count) of cell c. Its users index it with constants only (the
// loops over the cells unrolled, or the pairs moved down), so it stays in
// registers.
struct QueryCells {
  int32_t start[8], count[8];
};

__device__ __forceinline__ QueryCells query_cells(const GridRefs& g, V3 q) {
  int32_t base[3], step[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = cell_coord(g.geom, q, k);
    base[k] = static_cast<int32_t>(floorf(c));
    step[k] = c - static_cast<float>(base[k]) >= 0.5f ? 1 : -1;
  }
  int2 se[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t h =
        hash_cell(base[0] + ((c & 1) ? step[0] : 0),
                  base[1] + ((c & 2) ? step[1] : 0),
                  base[2] + ((c & 4) ? step[2] : 0), g.geom.table_size);
    se[c] = __ldg(reinterpret_cast<const int2*>(g.cell_se +
                                                2 * static_cast<int64_t>(h)));
  }
  QueryCells qc;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    qc.start[c] = se[c].x;
    qc.count[c] = se[c].y - se[c].x > 0 ? se[c].y - se[c].x : 0;
  }
  return qc;
}

// kept = min(count, cap), in the one-brick mode also <= 8 - (start & 7).
__device__ __forceinline__ int32_t kept_of(const GridRefs& g, int32_t start,
                                           int32_t count) {
  int32_t kept = count < g.cap ? count : g.cap;
  if (g.one_brick && kept > 8 - (start & 7)) kept = 8 - (start & 7);
  return kept;
}

// count / kept (1 without reweighting).
__device__ __forceinline__ float window_weight(const GridRefs& g,
                                              int32_t count, int32_t kept) {
  return g.reweight ? static_cast<float>(count) /
                          static_cast<float>(kept > 1 ? kept : 1)
                    : 1.0f;
}

__device__ __forceinline__ const float* photon_row(const GridRefs& g,
                                                   int64_t p) {
  return g.rows + kPhotonRow * p;
}

__device__ __forceinline__ bool in_range(const GridRefs& g, V3 q,
                                         const float* row) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  return length_sq(sub(q, v3(a.x, a.y, a.z))) <= g.r2;
}

constexpr int kFoldBatch = 8;  // candidate rows loaded before their tests

// Folds fold(photon, w) over the in-range candidates of query q, in the
// JAX order; returns the photons the cap left out (count - kept, summed).
// The cells are taken in order from the registers (the next pair moves
// down a cell); a cell's candidates are tested kFoldBatch at a time, their
// positions loaded together, then the in-range ones folded in ascending
// order (each row re-read whole, from L1).
template <class Fold>
__device__ __forceinline__ int32_t fold_neighbors(const GridRefs& g, V3 q,
                                                  Fold&& fold) {
  QueryCells qc = query_cells(g, q);
  int32_t dropped = 0;
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
    const int32_t start = qc.start[0], count = qc.count[0];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      qc.start[j] = qc.start[j + 1];
      qc.count[j] = qc.count[j + 1];
    }
    const int32_t kept = kept_of(g, start, count);
    const float w = window_weight(g, count, kept);
    for (int32_t k0 = 0; k0 < kept; k0 += kFoldBatch) {
      uint32_t in = 0u;
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        if (k0 + j < kept) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(
              photon_row(g, start + k0 + j)));
          if (length_sq(sub(q, v3(a.x, a.y, a.z))) <= g.r2) in |= 1u << j;
        }
      }
      while (in != 0u) {
        const int j = __ffs(static_cast<int>(in)) - 1;
        in &= in - 1u;
        fold(photon_fields(photon_row(g, start + k0 + j)), w);
      }
    }
    dropped += count - kept;
  }
  return dropped;
}

// neighbor_slots' slots of query q in its order (ops/hashgrid.py:412): M =
// 8 x cap slots (c, k) holding photon start + k from the two bricks from
// start's (the second clamped to the last), a candidate for k < kept; or,
// in the one-brick mode, M = 64 slots (c, k) holding photon k of start's
// brick, a candidate for rel = k - (start & 7) in [0, kept). Calls
// visit(m, row, ok, w) with ok = candidate && in range: for every slot with
// kAll, else for the candidates only (which are fold_neighbors' photons in
// its order, so a sum over them is the fold's). Returns count - kept summed
// over the cells. Needs 1 <= cap <= 8.
template <bool kAll, class Visit>
__device__ __forceinline__ int32_t neighbor_slots(const GridRefs& g, V3 q,
                                                  Visit&& visit) {
  const QueryCells qc = query_cells(g, q);
  const int64_t max_brick = g.n_rows / 8 - 1;
  const int per_cell = g.one_brick ? 8 : g.cap;
  int32_t dropped = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int32_t start = qc.start[c], count = qc.count[c];
    const int32_t kept = kept_of(g, start, count);
    const float w = window_weight(g, count, kept);
    const int32_t a = start & 7;
    const int64_t w0 = start >> 3;
    for (int k = 0; k < per_cell; ++k) {
      int64_t p;
      bool cand;
      if (g.one_brick) {
        p = ((w0 < max_brick ? w0 : max_brick) << 3) + k;
        cand = k - a >= 0 && k - a < kept;
      } else {
        const int64_t b = w0 + ((a + k) >> 3);
        p = ((b < max_brick ? b : max_brick) << 3) + ((a + k) & 7);
        cand = k < kept;
      }
      if (!kAll && !cand) continue;
      const float* row = photon_row(g, p);
      visit(c * per_cell + k, row, cand && in_range(g, q, row), w);
    }
    dropped += count - kept;
  }
  return dropped;
}

// neighbor_slots_compact's slot k < cap_q of query q (ops/hashgrid.py:512):
// the k-th entry of the cell-major stream of kept photons; past the stream
// photon 0, not ok, weight count / kept of no cell.
struct CompactSlot {
  int64_t p;
  bool ok;  // a stream entry (the distance test is the caller's)
  float w;
};

__device__ __forceinline__ CompactSlot compact_slot(const GridRefs& g,
                                                    const QueryCells& qc,
                                                    const int32_t* kept,
                                                    int32_t total, int cap_q,
                                                    int k) {
  CompactSlot s;
  s.ok = k < (total < cap_q ? total : cap_q);
  // the first cell whose kept photons reach past k (8: none), the kept
  // photons before it, its start and weight: an unrolled select
  int32_t prev = 0, start = 0;
  float w = window_weight(g, 0, 0);
  bool found = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!found && prev + kept[c] > k) {
      found = true;
      start = qc.start[c];
      w = window_weight(g, qc.count[c], kept[c]);
    } else if (!found) {
      prev += kept[c];
    }
  }
  s.p = s.ok ? static_cast<int64_t>(start) + k - (found ? prev : 0) : 0;
  s.w = w;
  return s;
}

}  // namespace tpt
