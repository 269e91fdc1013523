// K6's key tables: the draw-key pairs of a launch, folded once on the card
// by a prologue queued before the host kernel, so every draw in the host
// costs one cipher on the lane's id (uniform_draw_key) and no lane folds a
// key that every lane at the same event shares.
//
// Replaces the lane-uniform key chains of the JAX integrators, which fold
// a key per (sample, bounce, draw) once per wavefront on the TPU: the
// classic unidirectional and naive draws draw_key(bounce_key(skey, lit), d)
// (cudapathtracer_tpu/models/unidirectional.py, naive.py), the BDPT / VCM
// walks' draw_key(bounce_key(key, depth), d) (models/paths.py:129), the
// classic VCM eye walk's bounce and NEE keys (models/vcm.py:150: NEE under
// fold_in(bounce_key(key_e, depth), 7)) and BDPT's s=1 keys
// fold_in(key_c, t) (models/bdpt.py:175). The host folds only the launch
// words it already passes (the sample's key, key_l / key_e / key_c); the
// prologue expands them: in K5's key kernel, which the host launches
// anyway, or in a small kernel of its own (K12's, the eye walk's, K13's
// pairs').
//
// A table is one or two KeyTableSpec: entry e of a spec is the pair
//   fold_in(fold_in(fold_in(fold_in(key, s0 + s), r), mid), draw0 + j)
// with the sample level only when samples > 0, the row level only when
// rows > 0 and the mid level only when mid >= 0; it is stored as a KeyPair
// at pair offset + (s * max(rows, 1) + r) * stride + j. Its bits are the
// JAX fold_in chain's (utils/rng.py:fold_in, with every data word below
// 2^31, so JAX's int32 data never wraps): tests/test_torch_key_table.py
// holds each schedule's plain builder to JAX and chip_smoke.py holds the
// card's tables to the plain builders.
//
// Bound: a table is at most a few thousand pairs of three or four ciphers
// each; the prologue is one short launch. In the hosts a pair is one 8-byte
// read-only load that lanes at the same event share.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace tpt {

// One draw key of a table, (k0, k1): 8 bytes, one read-only load.
using KeyPair = uint2;

__host__ __device__ __forceinline__ KeyPair key_pair(uint32_t k0,
                                                    uint32_t k1) {
  return make_uint2(k0, k1);
}

struct KeyTableSpec {
  uint32_t k0, k1;   // the launch word: a key pair
  uint32_t s0;       // the first sample (samples > 0)
  uint32_t draw0;    // the first draw id
  int32_t samples;   // 0: no sample level
  int32_t rows;      // 0: no row level (one row)
  int32_t mid;       // -1: no mid level
  int32_t draws;
  int32_t stride;    // pairs from one row to the next
  int32_t offset;    // the pair entry 0 goes to
  __host__ __device__ int64_t count() const {
    return static_cast<int64_t>(samples > 0 ? samples : 1) *
           (rows > 0 ? rows : 1) * draws;
  }
};

// A table of up to two specs, which tile it: its length in pairs is
// key_table_entries.
struct KeyTables {
  KeyTableSpec spec[2];
  int32_t specs;
};

// Entry e of spec t and where it goes.
__device__ __forceinline__ void key_table_pair(const KeyTableSpec& t,
                                               int64_t e, KeyPair* out) {
  const int j = static_cast<int>(e % t.draws);
  const int64_t sr = e / t.draws;
  const int rows = t.rows > 0 ? t.rows : 1;
  const int r = static_cast<int>(sr % rows);
  const int64_t s = sr / rows;
  uint32_t k0 = t.k0, k1 = t.k1;
  if (t.samples > 0)
    fold_in(k0, k1, t.s0 + static_cast<uint32_t>(s), k0, k1);
  if (t.rows > 0) fold_in(k0, k1, static_cast<uint32_t>(r), k0, k1);
  if (t.mid >= 0) fold_in(k0, k1, static_cast<uint32_t>(t.mid), k0, k1);
  fold_in(k0, k1, t.draw0 + static_cast<uint32_t>(j), k0, k1);
  out[t.offset + sr * t.stride + j] = key_pair(k0, k1);
}

// Thread `e` of a prologue writes entry e of the table (entries of spec 0
// first); a thread past the table writes nothing.
__device__ __forceinline__ void key_table_entry(const KeyTables& kt,
                                                int64_t e, KeyPair* out) {
  for (int i = 0; i < kt.specs; ++i) {
    const int64_t n = kt.spec[i].count();
    if (e < n) {
      key_table_pair(kt.spec[i], e, out);
      return;
    }
    e -= n;
  }
}

__host__ __device__ inline int64_t key_table_entries(const KeyTables& kt) {
  int64_t n = 0;
  for (int i = 0; i < kt.specs; ++i) n += kt.spec[i].count();
  return n;
}

// The prologue of a host without threads of its own to spare: one thread
// an entry (internal to each source that launches it).
namespace {

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    key_table_kernel(KeyTables kt, KeyPair* __restrict__ out) {
  key_table_entry(kt, static_cast<int64_t>(blockIdx.x) * kThreads +
                          threadIdx.x, out);
}

template <int kThreads = 128>
inline void launch_key_table(const KeyTables& kt, KeyPair* out,
                             cudaStream_t st) {
  const int64_t n = key_table_entries(kt);
  if (n > 0)
    key_table_kernel<kThreads>
        <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
           st>>>(kt, out);
}

}  // namespace

inline KeyTableSpec key_spec(uint32_t k0, uint32_t k1, int32_t rows,
                             int32_t draws, int32_t stride = 0,
                             int32_t offset = 0, int32_t mid = -1,
                             uint32_t draw0 = 0u) {
  KeyTableSpec t;
  t.k0 = k0;
  t.k1 = k1;
  t.s0 = 0u;
  t.samples = 0;
  t.rows = rows;
  t.mid = mid;
  t.draw0 = draw0;
  t.draws = draws;
  t.stride = stride > 0 ? stride : draws;
  t.offset = offset;
  return t;
}

// ---- each host's table -----------------------------------------------------
// The row strides the hosts read with (pairs a row).
constexpr int kUniKeyDraws = 9;   // K5: draws 0-8 a row
constexpr int kWalkKeyDraws = 4;  // K12: the BSDF draws 0-3
constexpr int kWalkEndDraws = 5;  // K12 light: the endpoint's 100..104
constexpr int kEyeKeyDraws = 7;   // the classic eye walk: BSDF 0-3, NEE 0-2
constexpr int kEyeNeeDraw = 4;    //   NEE's first pair in the row
constexpr int kNeeKeyDraws = 3;   // K13's s=1: the light point's draws 0-2

// K5's draw keys, samples s0 .. s0+k-1 under the base key: with rows > 0
// (the classic and naive schedules) [k][rows][9] pairs
// draw_key(bounce_key(skey, lit), d), lit < rows, and with rows 0 (the
// mega schedule) [k][9] pairs draw_key(skey, d); skey = fold_in(base, s)
// (models/unidirectional.sample_key_table).
inline KeyTables uni_key_tables(uint32_t b0, uint32_t b1, uint32_t s0,
                                int32_t k, int32_t rows) {
  KeyTables kt;
  kt.spec[0] = key_spec(b0, b1, rows, kUniKeyDraws);
  kt.spec[0].s0 = s0;
  kt.spec[0].samples = k;
  kt.specs = 1;
  return kt;
}

// K12 under the walk key: [max_depth][4] BSDF pairs of bounce_key(key, b),
// then the 5 endpoint pairs draw_key(key, 100..104)
// (models/paths.walk_key_table; the keyed walk's host table).
inline KeyTables walk_key_tables(uint32_t k0, uint32_t k1,
                                 int32_t max_depth) {
  KeyTables kt;
  kt.spec[0] = key_spec(k0, k1, max_depth, kWalkKeyDraws);
  kt.spec[1] = key_spec(k0, k1, 0, kWalkEndDraws, 0,
                        max_depth * kWalkKeyDraws, -1, 100u);
  kt.specs = 2;
  return kt;
}

// The classic VCM / SPPM eye walk under key_e: row `depth` holds the BSDF
// pairs draw_key(bounce_key(key_e, depth), 0..3), then NEE's
// draw_key(fold_in(bounce_key(key_e, depth), 7), 0..2)
// (models/vcm.eye_key_table).
inline KeyTables eye_key_tables(uint32_t k0, uint32_t k1, int32_t depth) {
  KeyTables kt;
  kt.spec[0] = key_spec(k0, k1, depth, kWalkKeyDraws, kEyeKeyDraws);
  kt.spec[1] = key_spec(k0, k1, depth, kNeeKeyDraws, kEyeKeyDraws,
                        kEyeNeeDraw, 7);
  kt.specs = 2;
  return kt;
}

// BDPT's s=1 (K13's pairs) under key_c: row t (0 .. eye_depth) holds
// draw_key(fold_in(key_c, t), 0..2) (models/bdpt.nee_key_table).
inline KeyTables nee_key_tables(uint32_t k0, uint32_t k1, int32_t eye_depth) {
  KeyTables kt;
  kt.spec[0] = key_spec(k0, k1, eye_depth + 1, kNeeKeyDraws);
  kt.specs = 1;
  return kt;
}

// The draws of one row of a device key table: draw d is one read-only
// load of its pair and one cipher on the lane's id.
struct RowDraws {
  const KeyPair* row;
  uint32_t id;
  __device__ __forceinline__ float operator()(int d) const {
    const KeyPair k = __ldg(row + d);
    return uniform_draw_key(k.x, k.y, id);
  }
};

}  // namespace tpt
