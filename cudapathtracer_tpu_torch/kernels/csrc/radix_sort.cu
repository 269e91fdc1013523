// K8's sort: a stable LSD radix sort of 32-bit keys with their indices.
//
// Replaces the stable sort inside cudapathtracer_tpu/ops/hashgrid.py:
// build_grid (line 151, jnp.argsort of the salted uint32 keys), which the
// port had computed with torch.sort on int64 keys and indices. It sorts
// photon_pack's uint32 keys (photon_grid.cu) and gives photon_table the
// uint32 order (sorted slot -> photon) and each slot's bucket.
//
// Passes of 8-bit digits, least significant first; the caller asks for the
// key bits that can be nonzero (the table size bounds them), so a pass
// whose digit is 0 for every key, the identity, is not run. Each pass is
// three launches:
//   radix_hist_kernel     one block a tile of kTile keys: the tile's digit
//                         histogram in shared memory (one atomicAdd for the
//                         lanes of a warp that share a digit), written
//                         digit-major into counts [256, tiles];
//   radix_scan_kernel     one block a digit: the exclusive prefix sums of
//                         its row of counts over the tiles, in place, and
//                         the digit's total;
//   radix_scatter_kernel  one block a tile: each key's destination is the
//                         keys of lower digits (the totals' prefix), plus
//                         the tile's offset in its digit's row, plus its
//                         stable rank in the tile. Ranks come in input
//                         order: a warp takes its 32 x kItems keys in
//                         chunks of 32, eight ballots (one a digit bit)
//                         give the lanes of a chunk that share a digit, a
//                         lane's rank is its group's lanes below it plus the
//                         warp's running count of that digit (a
//                         warp-private histogram in shared memory), and the
//                         warps' counts are summed in warp order. The
//                         tile's keys and indices are then put in digit
//                         order in shared memory and written out in it, so
//                         neighbouring threads write neighbouring slots.
// The first pass reads no index (a key's index is its position); the last
// writes no key, only the order and gather[order] (photon_pack's buckets,
// read once a photon, so photon_table reads them coalesced).
//
// Bound: bytes. A pass reads the keys twice (histogram, scatter) and the
// indices once, and writes both once: 20 B a key (12,441,600 keys and 4
// passes at 1080p: ~1 GB, ~0.30 ms at 3.35 TB/s); the counts are 1 KB a
// tile. Design: every read is coalesced, the writes go out in runs of a
// digit (kTile / 256 keys a run on average), and a pass takes no atomic on
// device memory and no host sync.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;
constexpr int kSortThreads = 256;  // one thread a digit in the block scans
constexpr int kWarps = kSortThreads / 32;
constexpr int kItems = 8;  // keys a thread
constexpr int kTile = kSortThreads * kItems;
constexpr int kScanThreads = 1024;

struct SortPass {
  const uint32_t* keys_in;   // [n]
  const uint32_t* vals_in;   // [n], null: the identity (first pass)
  uint32_t* keys_out;        // [n], null on the last pass
  uint32_t* vals_out;        // [n]
  const uint32_t* gather;    // [n] read at vals on the last pass, or null
  uint32_t* gathered;        // [n] written beside vals_out, or null
  uint32_t* counts;          // [kDigits, tiles]
  uint32_t* totals;          // [kDigits]
  int64_t n;
  int64_t tiles;
  int shift;
};

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
// kSortThreads threads (scratch: kWarps words). Every thread calls it.
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

__global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(SortPass s) {
  __shared__ uint32_t hist[kDigits];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = key_index(tile, warp, c, lane);
    const bool live = i < s.n;
    const uint32_t d = live ? (s.keys_in[i] >> s.shift) & (kDigits - 1) : 0u;
    const unsigned peers = same_digit(d, live);
    if (live && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  s.counts[threadIdx.x * s.tiles + tile] = hist[threadIdx.x];
}

// Block d: row d of counts [kDigits, tiles] to its exclusive prefix sums,
// totals[d] its sum.
__global__ void __launch_bounds__(kScanThreads)
radix_scan_kernel(SortPass s) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  __shared__ uint32_t carry;
  uint32_t* row = s.counts + static_cast<int64_t>(blockIdx.x) * s.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int64_t t0 = 0; t0 < s.tiles; t0 += kScanThreads) {
    const int64_t t = t0 + threadIdx.x;
    const uint32_t own = t < s.tiles ? row[t] : 0;
    uint32_t x = own;  // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const uint32_t base = carry;
    if (t < s.tiles)
      row[t] = base + x - own + (warp > 0 ? warp_sums[warp - 1] : 0);
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1)
      carry = base + warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) s.totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(SortPass s) {
  __shared__ uint32_t whist[kWarps][kDigits];  // a warp's count, then slot
  __shared__ uint32_t gbase[kDigits];  // output slot minus the tile slot
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t skey[kTile], sval[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  for (int w = 0; w < kWarps; ++w) whist[w][threadIdx.x] = 0;
  __syncthreads();

  uint32_t key[kItems], val[kItems], rank[kItems];
  const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = key_index(tile, warp, c, lane);
    const bool live = i < s.n;
    key[c] = live ? s.keys_in[i] : 0u;
    val[c] = live ? (s.vals_in != nullptr ? s.vals_in[i]
                                          : static_cast<uint32_t>(i))
                  : 0u;
    const uint32_t d = (key[c] >> s.shift) & (kDigits - 1);
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
    const int t = threadIdx.x;
    uint32_t count = 0;
    for (int w = 0; w < kWarps; ++w) count += whist[w][t];
    const uint32_t local = block_exclusive(count, scratch);
    const uint32_t lower = block_exclusive(s.totals[t], scratch);
    uint32_t run = local;  // the warps' counts to tile slots, in warp order
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t x = whist[w][t];
      whist[w][t] = run;
      run += x;
    }
    gbase[t] = lower + s.counts[t * s.tiles + tile] - local;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (key_index(tile, warp, c, lane) >= s.n) continue;
    const uint32_t d = (key[c] >> s.shift) & (kDigits - 1);
    const uint32_t slot = whist[warp][d] + rank[c];
    skey[slot] = key[c];
    sval[slot] = val[c];
  }
  __syncthreads();
  const int64_t left = s.n - tile * kTile;
  const int live = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = threadIdx.x; j < live; j += kSortThreads) {
    const uint32_t k = skey[j], v = sval[j];
    const uint32_t dst = gbase[(k >> s.shift) & (kDigits - 1)] + j;
    if (s.keys_out != nullptr) s.keys_out[dst] = k;
    s.vals_out[dst] = v;
    if (s.gathered != nullptr) s.gathered[dst] = s.gather[v];
  }
}

}  // namespace

// Sorts keys [n] (uint32, only the low `bits` may be nonzero) stably and
// leaves them as they are. keys_a, keys_b, vals_tmp [n], counts
// [256 * ceil(n / kTile)] and totals [256]: scratch; order [n]: out, the
// sorted position's index; gather [n] (nullable): gathered [n] =
// gather[order]. Returns the first launch error.
extern "C" int tpt_radix_sort32(const uint32_t* keys, int64_t n, int32_t bits,
                                uint32_t* keys_a, uint32_t* keys_b,
                                uint32_t* vals_tmp, uint32_t* counts,
                                uint32_t* totals, uint32_t* order,
                                const uint32_t* gather, uint32_t* gathered,
                                void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = (bits + kBits - 1) / kBits;
  SortPass s;
  s.n = n;
  s.tiles = (n + kTile - 1) / kTile;
  s.counts = counts;
  s.totals = totals;
  // pass p writes keys into kbuf[p % 2] and indices into vbuf[p % 2]; the
  // indices ping-pong so that the last pass writes into order
  uint32_t* kbuf[2] = {keys_a, keys_b};
  uint32_t* vbuf[2] = {(passes % 2 == 0) ? vals_tmp : order,
                       (passes % 2 == 0) ? order : vals_tmp};
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    s.shift = p * kBits;
    s.keys_in = p == 0 ? keys : kbuf[(p + 1) % 2];
    s.keys_out = last ? nullptr : kbuf[p % 2];
    s.vals_in = p == 0 ? nullptr : vbuf[(p + 1) % 2];
    s.vals_out = vbuf[p % 2];
    s.gather = last ? gather : nullptr;
    s.gathered = last ? gathered : nullptr;
    const unsigned blocks = static_cast<unsigned>(s.tiles);
    radix_hist_kernel<<<blocks, kSortThreads, 0, st>>>(s);
    radix_scan_kernel<<<kDigits, kScanThreads, 0, st>>>(s);
    radix_scatter_kernel<<<blocks, kSortThreads, 0, st>>>(s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
