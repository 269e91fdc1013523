// K9's materialised forms over a batch of queries, one thread per query:
// every candidate slot's photon row, its in-range flag and its weight, for
// the comparison with the plain versions (ops/hashgrid.py). On the mega
// path the same slot enumeration (hashgrid.cuh neighbor_slots) runs inside
// the mega eye pass's gather (eye_gather.cu), which sums over the slots
// instead of storing them; this launch is its test entry.
//
// Replaces cudapathtracer_tpu/ops/hashgrid.py:neighbor_slots (412),
// neighbor_slots_compact (512) and gather_neighbors (203), by mode:
//   0 slots    rows [M,N,8], ok [M,N], wgt [M,N], dropped [N]; M = 64 in
//              the one-brick mode, else 8 x cap;
//   1 compact  the same with M = cap_q;
//   2 gather   rows [8 x cap, N, 8] and ok (in_range) [8 x cap, N].
// Bound: memory: the output rows (32 bytes per slot, written once) and the
// scattered photon-row reads, 8 (start, end) reads per query.
// Design: the cell table (hashgrid.cuh query_cells) and the kept counts
// stay in registers (every loop over the cells is unrolled).

#include <cuda_runtime.h>

#include <cstdint>

#include "hashgrid.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kModeSlots = 0;
constexpr int kModeCompact = 1;
constexpr int kModeGather = 2;

struct SlotsLaunch {
  tpt::GridRefs g;
  const float* query;   // [N,3]
  const bool* active;   // [N] or null (all active)
  float* rows;          // [M,N,8]
  bool* ok;             // [M,N]
  float* wgt;           // [M,N] (not in gather mode)
  int32_t* dropped;     // [N] (not in gather mode)
  int64_t n;
  int mode, cap_q;
};

__device__ __forceinline__ void put_slot(const SlotsLaunch& s, int m,
                                         int64_t i, const float* row,
                                         bool ok) {
  const int64_t k = m * s.n + i;
  const float4* src = reinterpret_cast<const float4*>(row);
  float4* dst = reinterpret_cast<float4*>(s.rows + 8 * k);
  dst[0] = src[0];
  dst[1] = src[1];
  s.ok[k] = ok;
}

__global__ void __launch_bounds__(kThreads) slots_kernel(SlotsLaunch s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= s.n) return;
  const tpt::GridRefs& g = s.g;
  const tpt::V3 q =
      tpt::v3(s.query[3 * i], s.query[3 * i + 1], s.query[3 * i + 2]);
  const bool active = s.active == nullptr || s.active[i];
  if (s.mode == kModeSlots) {
    const int32_t dr = tpt::neighbor_slots<true>(
        g, q, [&](int m, const float* row, bool ok, float w) {
          put_slot(s, m, i, row, active && ok);
          s.wgt[m * s.n + i] = w;
        });
    s.dropped[i] = active ? dr : 0;
    return;
  }
  const tpt::QueryCells qc = tpt::query_cells(g, q);
  if (s.mode == kModeGather) {  // cells with the x step outermost
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int c = (x >> 2) | (x & 2) | ((x & 1) << 2);
      for (int k = 0; k < g.cap; ++k) {
        const bool ok = active && k < qc.count[c];
        const float* row =
            tpt::photon_row(g, ok ? static_cast<int64_t>(qc.start[c]) + k : 0);
        put_slot(s, x * g.cap + k, i, row, ok && tpt::in_range(g, q, row));
      }
    }
    return;
  }
  int32_t kept[8], total = 0, over = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    kept[c] = tpt::kept_of(g, qc.start[c], qc.count[c]);
    total += kept[c];
    over += qc.count[c] - kept[c];
  }
  for (int k = 0; k < s.cap_q; ++k) {
    const tpt::CompactSlot cs =
        tpt::compact_slot(g, qc, kept, total, s.cap_q, k);
    const float* row = tpt::photon_row(g, active ? cs.p : 0);
    put_slot(s, k, i, row, active && cs.ok && tpt::in_range(g, q, row));
    s.wgt[k * s.n + i] = cs.w;
  }
  s.dropped[i] = active ? over + (total > s.cap_q ? total - s.cap_q : 0) : 0;
}

}  // namespace

// ptrs: grid rows [P8,8], cell_se [T+1,2], query [N,3], active (0 = all),
// rows out, ok out, wgt out (0 in gather mode), dropped out (0 in gather
// mode). iv: n, mode, table_size, max_per_cell, cap_q, one_brick,
// reweight, P8. fv: scene_min[3], cell_size, merge radius squared. Returns
// the launch's cudaError_t.
extern "C" int tpt_neighbor_slots(const int64_t* ptrs, const int64_t* iv,
                                  const float* fv, void* stream) {
  SlotsLaunch s;
  tpt::GridRefs& g = s.g;
  g.rows = reinterpret_cast<const float*>(ptrs[0]);
  g.cell_se = reinterpret_cast<const int32_t*>(ptrs[1]);
  s.query = reinterpret_cast<const float*>(ptrs[2]);
  s.active = reinterpret_cast<const bool*>(ptrs[3]);
  s.rows = reinterpret_cast<float*>(ptrs[4]);
  s.ok = reinterpret_cast<bool*>(ptrs[5]);
  s.wgt = reinterpret_cast<float*>(ptrs[6]);
  s.dropped = reinterpret_cast<int32_t*>(ptrs[7]);
  s.n = iv[0];
  s.mode = static_cast<int>(iv[1]);
  g.geom.table_size = static_cast<uint32_t>(iv[2]);
  g.cap = static_cast<int>(iv[3]);
  s.cap_q = static_cast<int>(iv[4]);
  g.one_brick = iv[5] != 0;
  g.reweight = iv[6] != 0;
  g.n_rows = iv[7];
  for (int k = 0; k < 3; ++k) g.geom.smin[k] = fv[k];
  g.geom.cell_size = fv[3];
  g.r2 = fv[4];
  const bool slots_ok = s.mode != kModeSlots || (g.cap >= 1 && g.cap <= 8);
  const bool outs_ok = s.mode == kModeGather ||
                       (s.wgt != nullptr && s.dropped != nullptr);
  if (s.mode < kModeSlots || s.mode > kModeGather || !slots_ok || !outs_ok ||
      g.cap < 1 || g.geom.table_size == 0 || g.n_rows < 16 ||
      g.n_rows % 8 != 0 || (s.mode == kModeCompact && s.cap_q < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s.n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((s.n + kThreads - 1) / kThreads);
  slots_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}
