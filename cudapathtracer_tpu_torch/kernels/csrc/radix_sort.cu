// K8's sort: the stable order of the photons' sort keys, and their
// buckets in that order, by an LSD radix sort with one launch a pass (a
// chained scan with decoupled look-back).
//
// Replaces the stable sort inside cudapathtracer_tpu/ops/hashgrid.py:
// build_grid (line 151, jnp.argsort of the salted uint32 keys), which the
// port had computed with torch.sort on int64 keys and indices. It takes
// photon_pack's buckets (photon_grid.cu) and gives photon_table the uint32
// order (sorted slot -> photon) and each slot's bucket. A photon's key is
// a function of its bucket h and index i, hashgrid.cuh's salted_key
// (h * 256 + an 8-bit tiebreak of i, uint32, wrapping above 2^24 buckets;
// h itself unsalted), so the passes carry (h, i) and derive the key where
// they need its digit: the last pass writes the sorted buckets as it
// writes the order, with no gather.
//
// Passes of 8-bit digits, least significant first; the caller asks for the
// key bits that can be nonzero (the table size bounds them), so a pass
// whose digit is 0 for every key, the identity, is not run. The launches:
//   radix_hist_kernel  once a sort: the digit histogram of every pass in
//                      one read of the buckets, 4 blocks an SM looping over
//                      chunks of 4096 (a block's counts in shared memory,
//                      split over 8 copies by lane so that lanes of one
//                      digit collide less, then one atomicAdd a digit and
//                      pass into device memory);
//   radix_pass_kernel  once a pass, one block a tile of kTile photons,
//                      tiles numbered in the order blocks start (an atomic
//                      counter), so a tile waits only on tiles that run. A
//                      thread loads its kItems pairs first, all in flight
//                      at once. Keys are ranked in input order: a warp
//                      takes its 32 x kItems keys in chunks of 32, eight
//                      ballots (one a digit bit) give the lanes of a chunk
//                      that share a digit, and a lane's rank is its group's
//                      lanes below it plus the warp's running count of that
//                      digit (a warp-private histogram in shared memory);
//                      the warps' counts are summed in warp order. One
//                      thread a digit then publishes the tile's count of
//                      its digit (tile 0: the digit's global start plus its
//                      count, an inclusive prefix) and looks back over the
//                      tiles before it, summing their counts until it reads
//                      one's inclusive prefix, so it learns where the
//                      tile's keys of its digit go, and publishes its own
//                      inclusive prefix. The tile's pairs are put in digit
//                      order in shared memory and written out in it, so
//                      neighbouring threads write neighbouring slots.
// A pair is 8 bytes between passes. The first pass reads only buckets (an
// index is its position); the last writes the order and the buckets.
//
// Bound: bytes. Input the buckets, outputs the order and the sorted
// buckets: 12 B a photon. The passes move 12 B a photon (first) and 16 B
// (the others), 60 B at 4 passes, and the histogram reads the buckets once
// more. Design: one launch a pass, no re-read of the keys to count them,
// no gather, every read coalesced, a thread's loads all in flight before
// it ranks, pairs written in runs of a digit (kTile / 256 = 12 pairs, 96
// B, a run on average), no atomic on device memory in a pass but the tile
// counter, no host sync. Tiles of 3072 (12 keys a thread) timed fastest
// of 2048, 3072 and 4096 (tools/k8_k15_attribution.py). The count of a
// tile and its flag share one word: 2 flag bits and a 30-bit count (the
// wrapper refuses n >= 2^30).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hashgrid.cuh"

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;
constexpr int kThreads = 256;  // one thread a digit
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 12;  // keys a thread
constexpr int kTile = kThreads * kItems;
constexpr int kMaxPasses = 4;
constexpr int kHistThreads = 256;
constexpr int kHistKeys = 16;  // keys a histogram thread
constexpr int kParts = 8;      // copies of a histogram block's counts
constexpr int kHistBlocksPerSm = 4;
constexpr uint32_t kFlagCount = 1u << 30;   // the tile's own count
constexpr uint32_t kFlagPrefix = 2u << 30;  // the inclusive prefix
constexpr uint32_t kValueMask = kFlagCount - 1u;

// The scratch words before the status words: the histograms, then the
// tile counters (one a pass).
constexpr int kHeadWords = kMaxPasses * kDigits + 32;

struct PassArgs {
  const uint32_t* bucket;  // [n], the first pass (pairs_in null)
  const uint2* pairs_in;   // [n] (bucket, index), later passes
  uint2* pairs_out;        // [n], all passes but the last
  uint32_t* order;         // [n], the last pass
  uint32_t* sorted;        // [n] the buckets in order, the last pass
  const uint32_t* hist;    // [kDigits]: this pass's digit histogram
  uint32_t* status;        // [tiles, kDigits]: flag | count, zeroed
  uint32_t* counter;       // the pass's tile counter, zeroed
  int64_t n;
  int shift;
  bool salted;
  uint32_t salt;
};

// The sort key of photon i in bucket h.
__device__ __forceinline__ uint32_t key_of(uint32_t h, uint32_t i,
                                           bool salted, uint32_t salt) {
  return salted ? tpt::salted_key(h, i, salt) : h;
}

// Key c of warp w's chunk order in tile t: chunks of 32 consecutive keys,
// a warp's kItems chunks consecutive, the warps in order.
__device__ __forceinline__ int64_t key_index(int64_t tile, int warp, int c,
                                             int lane) {
  return tile * kTile + (warp * kItems + c) * 32 + lane;
}

// The lanes of the warp that are live and hold the digit d: one ballot a
// digit bit (a lane that is not live gets a mask without itself).
__device__ __forceinline__ unsigned same_digit(uint32_t d, bool live) {
  unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// The exclusive prefix sum of one value a thread over the block's
// kThreads threads (scratch: kWarps words). Every thread calls it.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t x,
                                                   uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  uint32_t below = 0;
  for (int w = 0; w < warp; ++w) below += scratch[w];
  return below + inc - x;
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Each block counts the digits of every pass over chunks of kHistThreads
// x kHistKeys photons (chunk b, b + gridDim.x, ...), warp-striped as the
// passes read them, then adds its counts into hist.
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const uint32_t* __restrict__ bucket, int64_t n,
                  int passes, bool salted, uint32_t salt,
                  uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[kMaxPasses][kDigits][kParts];
  for (int j = threadIdx.x; j < kMaxPasses * kDigits * kParts;
       j += kHistThreads)
    (&sh[0][0][0])[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int64_t kChunk = int64_t{kHistThreads} * kHistKeys;
  for (int64_t base = blockIdx.x * kChunk; base < n;
       base += gridDim.x * kChunk) {
    uint32_t h[kHistKeys];
#pragma unroll
    for (int c = 0; c < kHistKeys; ++c) {  // every load in flight at once
      const int64_t i = base + (warp * kHistKeys + c) * 32 + lane;
      h[c] = i < n ? bucket[i] : 0u;
    }
#pragma unroll
    for (int c = 0; c < kHistKeys; ++c) {
      const int64_t i = base + (warp * kHistKeys + c) * 32 + lane;
      if (i >= n) continue;
      const uint32_t k =
          key_of(h[c], static_cast<uint32_t>(i), salted, salt);
      for (int p = 0; p < passes; ++p)
        atomicAdd(&sh[p][(k >> (p * kBits)) & (kDigits - 1)][lane % kParts],
                  1u);
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    uint32_t c = 0;
    for (int q = 0; q < kParts; ++q) c += sh[p][threadIdx.x][q];
    if (c != 0) atomicAdd(&hist[p * kDigits + threadIdx.x], c);
  }
}

__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(PassArgs a) {
  __shared__ uint32_t whist[kWarps][kDigits];  // a warp's count, then slot
  __shared__ uint32_t gbase[kDigits];   // output slot minus the tile slot
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint2 stage[kTile];
  __shared__ int64_t tile_of_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x;  // the digit this thread counts
  if (t == 0) tile_of_block = atomicAdd(a.counter, 1u);
  for (int w = 0; w < kWarps; ++w) whist[w][t] = 0;
  __syncthreads();
  const int64_t tile = tile_of_block;

  uint32_t hv[kItems], val[kItems], rank[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {  // every load in flight at once
    const int64_t i = key_index(tile, warp, c, lane);
    const bool live = i < a.n;
    if (a.pairs_in == nullptr) {
      hv[c] = live ? a.bucket[i] : 0u;
      val[c] = static_cast<uint32_t>(i);
    } else {
      const uint2 p = live ? a.pairs_in[i] : make_uint2(0u, 0u);
      hv[c] = p.x;
      val[c] = p.y;
    }
  }
  const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const bool live = key_index(tile, warp, c, lane) < a.n;
    const uint32_t d =
        (key_of(hv[c], val[c], a.salted, a.salt) >> a.shift) & (kDigits - 1);
    const unsigned peers = same_digit(d, live);
    const uint32_t run = live ? whist[warp][d] : 0u;
    rank[c] = run + __popc(peers & below_me);
    __syncwarp();
    if (live && lane == __ffs(peers) - 1)
      whist[warp][d] = run + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {  // thread t, digit t
    uint32_t count = 0;
    for (int w = 0; w < kWarps; ++w) count += whist[w][t];
    uint32_t* own = a.status + tile * kDigits + t;
    uint32_t before;  // the keys of digit t in the tiles before this one
    if (tile == 0) {
      before = block_exclusive(a.hist[t], scratch);  // the lower digits
      store_status(own, kFlagPrefix | (before + count));
    } else {
      store_status(own, kFlagCount | count);
      before = 0;
      for (int64_t j = tile - 1;; --j) {
        const uint32_t* s = a.status + j * kDigits + t;
        uint32_t v;
        do {
          v = load_status(s);
        } while ((v & ~kValueMask) == 0u);
        before += v & kValueMask;
        if (v & kFlagPrefix) break;
      }
      store_status(own, kFlagPrefix | (before + count));
    }
    const uint32_t local = block_exclusive(count, scratch);
    uint32_t run = local;  // the warps' counts to tile slots, in warp order
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t x = whist[w][t];
      whist[w][t] = run;
      run += x;
    }
    gbase[t] = before - local;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (key_index(tile, warp, c, lane) >= a.n) continue;
    const uint32_t d =
        (key_of(hv[c], val[c], a.salted, a.salt) >> a.shift) & (kDigits - 1);
    stage[whist[warp][d] + rank[c]] = make_uint2(hv[c], val[c]);
  }
  __syncthreads();
  const int64_t left = a.n - tile * kTile;
  const int live = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = t; j < live; j += kThreads) {
    const uint2 p = stage[j];
    const uint32_t d =
        (key_of(p.x, p.y, a.salted, a.salt) >> a.shift) & (kDigits - 1);
    const uint32_t dst = gbase[d] + j;
    if (a.pairs_out != nullptr) {
      a.pairs_out[dst] = p;
    } else {
      a.order[dst] = p.y;
      a.sorted[dst] = p.x;
    }
  }
}

}  // namespace

// The scratch words a sort of n keys needs (zeroed by the sort itself).
extern "C" int64_t tpt_radix_sort32_scratch(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return kHeadWords + kMaxPasses * tiles * kDigits;
}

// Sorts the photons of bucket [n] (uint32) stably by their keys (salted
// with salt if salted, else the bucket), of which only the low `bits` may
// be nonzero, and leaves bucket as it is. pairs_a, pairs_b [n] uint2 and
// scratch [tpt_radix_sort32_scratch(n)] uint32: scratch; order [n]: out,
// the sorted position's photon; sorted [n]: out, bucket[order]. Returns
// the first launch error.
extern "C" int tpt_radix_sort32(const uint32_t* bucket, int64_t n,
                                int32_t bits, int32_t salted, uint32_t salt,
                                void* pairs_a, void* pairs_b,
                                uint32_t* scratch, uint32_t* order,
                                uint32_t* sorted, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 30) || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = (bits + kBits - 1) / kBits;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0,
      (kHeadWords + passes * tiles * kDigits) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks =
      (n + int64_t{kHistThreads} * kHistKeys - 1) / (kHistThreads * kHistKeys);
  const int64_t hist_blocks = std::min<int64_t>(chunks, kHistBlocksPerSm * sms);
  radix_hist_kernel<<<static_cast<unsigned>(hist_blocks), kHistThreads, 0,
                      st>>>(bucket, n, passes, salted != 0, salt, scratch);
  uint2* pbuf[2] = {static_cast<uint2*>(pairs_a),
                    static_cast<uint2*>(pairs_b)};
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    PassArgs a;
    a.bucket = bucket;
    a.pairs_in = p == 0 ? nullptr : pbuf[(p + 1) % 2];
    a.pairs_out = last ? nullptr : pbuf[p % 2];
    a.order = order;
    a.sorted = sorted;
    a.hist = scratch + p * kDigits;
    a.counter = scratch + kMaxPasses * kDigits + p;
    a.status = scratch + kHeadWords + p * tiles * kDigits;
    a.n = n;
    a.shift = p * kBits;
    a.salted = salted != 0;
    a.salt = salt;
    radix_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
