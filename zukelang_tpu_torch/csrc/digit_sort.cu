// K4: per-row stable sort of small int32 keys, returning (sorted keys,
// order).  Replaces the bitonic network of bitonic_argsort /
// bitonic_sort_pairs (zukelang_tpu/ops/pallas_kernels.py:1173, :1139;
// kernel _bitonic_kernel :1083, cross-chunk passes :1125).
//
// Bound: bytes.  A row of n keys is read and written as (key, index)
// pairs a few times; there is no arithmetic to speak of.  The rows are few
// (1 to a few hundred Pippenger windows), so a design of one block per row
// leaves most of the 132 SMs idle, and a scatter in which one warp walks
// the row is a chain of n / 32 dependent steps.
//
// Design: an LSD radix sort on the key, with at most 8 bits per pass (two
// passes for keys below 2^16, the windows of c <= 16).  Each row is cut
// into tiles of kTile keys and every tile is a block, so a call runs
// rows * tiles blocks.  A pass is three kernels:
//   1. k_radix_hist:    per-tile digit counts, counts[row][digit][tile];
//   2. k_radix_scan:    per row, one block scans counts in that order, so
//                       each (digit, tile) count becomes its first output
//                       position in the row;
//   3. k_radix_scatter: each warp ranks its 32-key steps with
//                       __match_any_sync (stable: earlier keys rank first),
//                       the block turns the per-warp ranks into positions
//                       within the tile, stages the tile in shared memory
//                       in digit order, and writes it out so that each
//                       digit's run goes to consecutive addresses.
// Every pass is stable, so the sort is stable and equals
// torch.sort(stable=True) word for word.  All eight warps of a block take
// part in every step.  A call of P passes runs 3 P kernels.
#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

constexpr int kSortThreads = 256;                 // 8 warps
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;                         // 32-key steps per warp
constexpr int kTile = kSortThreads * kItems;      // 2048 keys per block
constexpr int kMaxDigits = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;

__device__ __forceinline__ int digit_of(int32_t key, int shift, int ndig) {
  return (int)(((uint32_t)key >> shift) & (uint32_t)(ndig - 1));
}

// Exclusive sum over the NW warps of a block; `total` gets the sum.
template <int NW>
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums,
                                                  int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int s = warp_sums[w];
    before += w < wid ? s : 0;
    total += s;
  }
  __syncthreads();
  return before + incl - v;
}

// Warp w ranks the keys of its kItems steps: rank[s] is the number of
// earlier keys of the warp's share with the same digit; warp_hist[d] ends
// as the warp's count of digit d.  Lanes past the row's end carry no key.
__device__ __forceinline__ void warp_rank(const int32_t* keys, int64_t base,
                                          int64_t n, int shift, int ndig,
                                          int* warp_hist, int32_t* key_out,
                                          int* dig_out, int* rank_out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t i = base + s * 32 + lane;
    const bool valid = i < n;
    const int32_t key = valid ? keys[i] : 0;
    const int d = valid ? digit_of(key, shift, ndig) : kMaxDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = valid ? warp_hist[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) warp_hist[d] = before + __popc(peers);
    __syncwarp();
    key_out[s] = key;
    dig_out[s] = d;
    rank_out[s] = before + __popc(peers & ((1u << lane) - 1u));
  }
}

__global__ void __launch_bounds__(kSortThreads)
k_radix_hist(const int32_t* __restrict__ keys, int32_t* __restrict__ counts,
             int64_t n, int tiles, int shift, int ndig) {
  __shared__ int warp_hist[kSortWarps][kMaxDigits];
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x, wid = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kSortWarps * kMaxDigits; k += kSortThreads)
    (&warp_hist[0][0])[k] = 0;
  __syncthreads();
  int32_t key[kItems];
  int dig[kItems], rank[kItems];
  warp_rank(keys + row * n, (int64_t)tile * kTile + wid * (kItems * 32), n,
            shift, ndig, warp_hist[wid], key, dig, rank);
  __syncthreads();
  const int d = threadIdx.x;
  if (d < ndig) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) c += warp_hist[w][d];
    counts[(row * ndig + d) * tiles + tile] = c;
  }
}

// Per row, an exclusive scan of counts in (digit, tile) order: each
// (digit, tile) count becomes its first output position in the row, the
// keys of smaller digits and of the same digit in earlier tiles before it.
__global__ void __launch_bounds__(kScanThreads)
k_radix_scan(int32_t* __restrict__ counts, int64_t len) {
  __shared__ int warp_sums[kScanThreads / 32];
  counts += (int64_t)blockIdx.x * len;
  int carry = 0;
  for (int64_t c0 = 0; c0 < len; c0 += kScanThreads * kScanItems) {
    const int64_t i0 = c0 + (int64_t)threadIdx.x * kScanItems;
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      v[u] = i0 + u < len ? counts[i0 + u] : 0;
      sum += v[u];
    }
    int total;
    int run = carry + block_exclusive_sum<kScanThreads / 32>(sum, warp_sums,
                                                             total);
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      if (i0 + u < len) counts[i0 + u] = run;
      run += v[u];
    }
    carry += total;
  }
}

// vals_in == nullptr: the values are the keys' indices in the row.
__global__ void __launch_bounds__(kSortThreads)
k_radix_scatter(const int32_t* __restrict__ keys_in,
                const int32_t* __restrict__ vals_in,
                const int32_t* __restrict__ counts,
                int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out,
                int64_t n, int tiles, int shift, int ndig) {
  __shared__ int warp_hist[kSortWarps][kMaxDigits];
  __shared__ int tile_start[kMaxDigits];   // digit's first slot in the tile
  __shared__ int row_start[kMaxDigits];    // digit's first slot in the row
  __shared__ int warp_sums[kSortWarps];
  __shared__ int32_t stage_key[kTile];
  __shared__ int32_t stage_val[kTile];
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x, wid = threadIdx.x >> 5;
  keys_in += row * n;
  keys_out += row * n;
  vals_out += row * n;
  if (vals_in != nullptr) vals_in += row * n;
  for (int k = threadIdx.x; k < kSortWarps * kMaxDigits; k += kSortThreads)
    (&warp_hist[0][0])[k] = 0;
  __syncthreads();

  const int64_t tile0 = (int64_t)tile * kTile;
  const int64_t base = tile0 + wid * (kItems * 32);
  int32_t key[kItems];
  int dig[kItems], rank[kItems];
  warp_rank(keys_in, base, n, shift, ndig, warp_hist[wid], key, dig, rank);
  __syncthreads();

  // per digit: the warps' counts -> each warp's first rank in the tile
  const int d = threadIdx.x;
  int tile_count = 0;
  if (d < ndig) {
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = warp_hist[w][d];
      warp_hist[w][d] = tile_count;
      tile_count += c;
    }
  }
  int total;
  const int start = block_exclusive_sum<kSortWarps>(tile_count, warp_sums,
                                                    total);
  if (d < ndig) {
    tile_start[d] = start;
    row_start[d] = counts[(row * ndig + d) * tiles + tile];
  }
  __syncthreads();

  // stage the tile in digit order
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t i = base + s * 32 + lane;
    if (i < n) {
      const int p = tile_start[dig[s]] + warp_hist[wid][dig[s]] + rank[s];
      stage_key[p] = key[s];
      stage_val[p] = vals_in != nullptr ? vals_in[i] : (int32_t)i;
    }
  }
  __syncthreads();

  // write the staged tile: consecutive slots of one digit go to
  // consecutive addresses of the row
  for (int j = threadIdx.x; j < total; j += kSortThreads) {
    const int32_t k = stage_key[j];
    const int dj = digit_of(k, shift, ndig);
    const int64_t pos = row_start[dj] + (j - tile_start[dj]);
    keys_out[pos] = k;
    vals_out[pos] = stage_val[j];
  }
}

}  // namespace zk

// keys: (rows, n) int32 in [0, nkeys); sorted, order: (rows, n).  Scratch
// from the caller: counts (rows, 256, tiles) int32 and, for two or more
// passes, tmp_keys and tmp_vals (rows, n) int32.  npass passes of `bits`
// bits each (bits[p] <= 8) sort by the low sum(bits) bits of the key.
extern "C" int zk_digit_sort(const void* keys, void* sorted, void* order,
                             void* counts, void* tmp_keys, void* tmp_vals,
                             int64_t rows, int64_t n, int npass,
                             const int* bits, void* stream) {
  using namespace zk;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)((n + kTile - 1) / kTile);
  if (rows > 65535 || npass < 1 || npass > 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  const int32_t* k_in = (const int32_t*)keys;
  const int32_t* v_in = nullptr;
  int shift = 0;
  for (int p = 0; p < npass; ++p) {
    if (bits[p] < 1 || bits[p] > 8) return (int)cudaErrorInvalidValue;
    const int ndig = 1 << bits[p];
    // the last pass writes the outputs; earlier ones alternate so that
    // no pass reads the buffer it writes
    const bool to_out = ((npass - 1 - p) & 1) == 0;
    int32_t* k_out = (int32_t*)(to_out ? sorted : tmp_keys);
    int32_t* v_out = (int32_t*)(to_out ? order : tmp_vals);
    k_radix_hist<<<grid, kSortThreads, 0, st>>>(k_in, (int32_t*)counts, n,
                                                tiles, shift, ndig);
    k_radix_scan<<<(unsigned)rows, kScanThreads, 0, st>>>(
        (int32_t*)counts, (int64_t)ndig * tiles);
    k_radix_scatter<<<grid, kSortThreads, 0, st>>>(
        k_in, v_in, (const int32_t*)counts, k_out, v_out, n, tiles, shift,
        ndig);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_in = k_out;
    v_in = v_out;
    shift += bits[p];
  }
  return (int)cudaSuccess;
}
