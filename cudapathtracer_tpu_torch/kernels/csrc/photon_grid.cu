// K8: the photon grid build, two kernels around a stable sort
// (radix_sort.cu).
//
// Replaces cudapathtracer_tpu/ops/hashgrid.py:build_grid (line 151) with
// the photon row of pack_photons (119), as the JAX VCM sample calls them
// (models/vcm.py:204-226):
//   photon_pack   one thread per stored light vertex k = row * N + lane of
//                 K12's depth-major light buffers: the 32-byte photon row
//                 (the position; the DECODED direction to the previous
//                 vertex encoded again, as the JAX package packs the
//                 decoded buffer field; beta half3 -> float -> half2 r|g,
//                 b|0; d_vcm; d_vm) and its bucket (the sentinel T unless
//                 valid and not delta). It also fills the (start, end)
//                 table with (P, 0). Its pack-only mode (no bucket, no
//                 table) writes the rows and each photon's validity byte
//                 instead: what a tile-sharded VCM sample all-gathers
//                 (cudapathtracer_tpu/models/vcm.py:212-219, photon_axis).
//   photon_bucket the rows mode: one thread per packed photon row of the
//                 gathered union, its bucket from the row's position and
//                 its validity byte, and the (P, 0) fill of the table; the
//                 same buckets and table as photon_pack's on the same
//                 photons, bit for bit (the rows hold the positions
//                 unchanged).
//   (radix_sort.cu's stable sort between the two launches, by the sort key
//   it derives from each bucket and index (salted: the bucket * 256 plus
//   an 8-bit tiebreak, uint32 and wrapping as there): the order, sorted
//   slot -> photon, and each slot's bucket)
//   photon_table  one thread per sorted slot: gathers the row, and
//                 atomicMin / atomicMax of the slot into its bucket's
//                 (start, end), JAX's scatter-min/max, once per run of
//                 equal buckets in a warp; threads past P write the zero
//                 padding rows. No boundary detection beyond the warp: above
//                 2^24 buckets the key wraps and a bucket's photons need not
//                 be contiguous, so min / max stays the rule.
//
// Bound: bytes. photon_pack reads ~43 bytes of buffers per vertex and writes
// a 32-byte row and a 4-byte bucket; photon_bucket reads a 12-byte position
// and a validity byte and writes a 4-byte bucket; photon_table reads a
// 4-byte index, a 4-byte bucket and a 32-byte row and writes the row, and
// the table of 8 (T + 1) bytes is written once and updated by atomics.
// Design: one thread per element, 16-byte vector loads and stores of the
// rows; the gather's row reads are scattered (sorted order), its index and
// bucket reads (the sort put the buckets in sorted order) and its writes
// coalesced.

#include <cuda_runtime.h>

#include <cstdint>

#include "bdpt.cuh"
#include "hashgrid.cuh"

namespace {

constexpr int kThreads = 256;

struct PackLaunch {
  tpt::PathBufs lb;    // [L, N]
  tpt::GridGeom geom;
  int64_t p;           // L * N
  float* rows;         // [P, 8]
  int32_t* bucket;     // [P]; null in the pack-only mode
  int32_t* cell_se;    // [T+1, 2]; null in the pack-only mode
  uint8_t* valid;      // [P] or null: 1 for a valid, non-delta photon
};

// The (P, 0) fill of the (start, end) table, strided over the P threads.
__device__ __forceinline__ void fill_table(int32_t* cell_se, int64_t k,
                                           int64_t p, uint32_t table_size) {
  for (int64_t t = k; t <= table_size; t += p) {
    cell_se[2 * t] = static_cast<int32_t>(p);
    cell_se[2 * t + 1] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) photon_pack_kernel(PackLaunch a) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= a.p) return;
  if (a.cell_se) fill_table(a.cell_se, k, a.p, a.geom.table_size);
  const tpt::V3 pos = tpt::v3(a.lb.pt[3 * k], a.lb.pt[3 * k + 1],
                              a.lb.pt[3 * k + 2]);
  const tpt::V3 wi = tpt::unpack_oct(a.lb.wo_oct[k]);
  const tpt::V3 beta = tpt::load_half3(a.lb.beta + 3 * k);
  const bool valid =
      a.lb.valid[k] && !tpt::unpack_flags(a.lb.flags[k]).is_delta;
  float4 r0, r1;
  r0.x = pos.x;
  r0.y = pos.y;
  r0.z = pos.z;
  r0.w = __uint_as_float(tpt::pack_oct(wi));
  r1.x = __uint_as_float(tpt::pack_half2(beta.x, beta.y));
  r1.y = __uint_as_float(tpt::pack_half2(beta.z, 0.0f));
  r1.z = a.lb.d_vcm[k];
  r1.w = a.lb.d_vm[k];
  reinterpret_cast<float4*>(a.rows + 8 * k)[0] = r0;
  reinterpret_cast<float4*>(a.rows + 8 * k)[1] = r1;
  if (a.valid) a.valid[k] = valid ? 1 : 0;
  if (!a.bucket) return;
  const uint32_t h = valid ? tpt::bucket_of(a.geom, pos) : a.geom.table_size;
  a.bucket[k] = static_cast<int32_t>(h);
}

struct BucketLaunch {
  const float* rows;     // [P, 8] packed photon rows
  const uint8_t* valid;  // [P]
  tpt::GridGeom geom;
  int64_t p;
  int32_t* bucket;       // [P]
  int32_t* cell_se;      // [T+1, 2]
};

__global__ void __launch_bounds__(kThreads)
    photon_bucket_kernel(BucketLaunch a) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= a.p) return;
  fill_table(a.cell_se, k, a.p, a.geom.table_size);
  const float4 r0 = reinterpret_cast<const float4*>(a.rows + 8 * k)[0];
  const uint32_t h = a.valid[k]
                         ? tpt::bucket_of(a.geom, tpt::v3(r0.x, r0.y, r0.z))
                         : a.geom.table_size;
  a.bucket[k] = static_cast<int32_t>(h);
}

struct TableLaunch {
  const float* rows;      // [P, 8]
  const int32_t* bucket;  // [P] in sorted order
  const uint32_t* order;  // [P] sorted slot -> photon
  int64_t p, p8;
  float* sorted;          // [P8, 8]
  int32_t* cell_se;       // [T+1, 2]
};

// Each warp updates a bucket once per run of equal buckets among its 32
// slots: the run's first slot takes the atomicMin, its last the atomicMax.
// The min (max) of a bucket's slots is the min (max) over its runs, so the
// table is the same, and the sentinel bucket (every invalid photon) takes
// 1/32 of the atomics on its two words.
__global__ void __launch_bounds__(kThreads) photon_table_kernel(TableLaunch a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool live = i < a.p;
  const int64_t src = live ? a.order[i] : 0;
  const int32_t h = live ? a.bucket[i] : -1;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int32_t h_prev = __shfl_up_sync(0xFFFFFFFFu, h, 1);
  const int32_t h_next = __shfl_down_sync(0xFFFFFFFFu, h, 1);
  if (i >= a.p8) return;
  float4* dst = reinterpret_cast<float4*>(a.sorted + 8 * i);
  if (!live) {
    dst[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4* row = reinterpret_cast<const float4*>(a.rows + 8 * src);
  dst[0] = row[0];
  dst[1] = row[1];
  int32_t* se =
      a.cell_se + 2 * static_cast<int64_t>(static_cast<uint32_t>(h));
  if (lane == 0 || h_prev != h) atomicMin(se, static_cast<int32_t>(i));
  if (lane == 31 || h_next != h)
    atomicMax(se + 1, static_cast<int32_t>(i + 1));
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// ptrs: the 11 light-buffer fields, rows, bucket, cell_se, valid (bucket
// and cell_se both null: the pack-only mode, which needs valid; valid may
// be null otherwise). iv: n (lanes), depth (stored vertices per lane),
// table_size (0 in the pack-only mode). fv: scene_min[3], cell_size.
// Returns the launch's cudaError_t.
extern "C" int tpt_photon_pack(const int64_t* ptrs, const int64_t* iv,
                               const float* fv, void* stream) {
  PackLaunch a;
  a.lb = tpt::path_bufs(ptrs, iv[0], static_cast<int>(iv[1]));
  a.p = iv[0] * iv[1];
  for (int k = 0; k < 3; ++k) a.geom.smin[k] = fv[k];
  a.geom.cell_size = fv[3];
  a.geom.table_size = static_cast<uint32_t>(iv[2]);
  a.rows = tpt::dev_ptr<float>(ptrs, 11);
  a.bucket = tpt::dev_ptr<int32_t>(ptrs, 12);
  a.cell_se = tpt::dev_ptr<int32_t>(ptrs, 13);
  a.valid = tpt::dev_ptr<uint8_t>(ptrs, 14);
  const bool pack_only = !a.bucket && !a.cell_se;
  if (a.p <= 0 || a.p >= (int64_t{1} << 31) ||
      (pack_only ? (!a.valid || iv[2] != 0)
                 : (!a.bucket || !a.cell_se || iv[2] <= 0 ||
                    iv[2] >= (int64_t{1} << 32))))
    return static_cast<int>(cudaErrorInvalidValue);
  photon_pack_kernel<<<blocks_for(a.p), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: rows, valid, bucket, cell_se. iv: p, table_size. fv: scene_min[3],
// cell_size. Returns the launch's cudaError_t.
extern "C" int tpt_photon_bucket(const int64_t* ptrs, const int64_t* iv,
                                 const float* fv, void* stream) {
  BucketLaunch a;
  a.rows = tpt::dev_ptr<const float>(ptrs, 0);
  a.valid = tpt::dev_ptr<const uint8_t>(ptrs, 1);
  a.bucket = tpt::dev_ptr<int32_t>(ptrs, 2);
  a.cell_se = tpt::dev_ptr<int32_t>(ptrs, 3);
  a.p = iv[0];
  for (int k = 0; k < 3; ++k) a.geom.smin[k] = fv[k];
  a.geom.cell_size = fv[3];
  a.geom.table_size = static_cast<uint32_t>(iv[1]);
  if (a.p <= 0 || a.p >= (int64_t{1} << 31) || iv[1] <= 0 ||
      iv[1] >= (int64_t{1} << 32) || !a.rows || !a.valid || !a.bucket ||
      !a.cell_se)
    return static_cast<int>(cudaErrorInvalidValue);
  photon_bucket_kernel<<<blocks_for(a.p), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: rows, bucket (sorted order), order, sorted, cell_se. iv: p, p8 (P plus its
// padding). Returns the launch's cudaError_t.
extern "C" int tpt_photon_table(const int64_t* ptrs, const int64_t* iv,
                                void* stream) {
  TableLaunch a;
  a.rows = tpt::dev_ptr<const float>(ptrs, 0);
  a.bucket = tpt::dev_ptr<const int32_t>(ptrs, 1);
  a.order = tpt::dev_ptr<const uint32_t>(ptrs, 2);
  a.sorted = tpt::dev_ptr<float>(ptrs, 3);
  a.cell_se = tpt::dev_ptr<int32_t>(ptrs, 4);
  a.p = iv[0];
  a.p8 = iv[1];
  if (a.p <= 0 || a.p8 < a.p) return static_cast<int>(cudaErrorInvalidValue);
  photon_table_kernel<<<blocks_for(a.p8), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
