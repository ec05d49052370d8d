// K7 for G2 on thread pairs: k_jac_scan (jac_scan.cu) over G2 points, each
// chunk lane held by two adjacent threads, one Fq component of every Fq2
// coordinate each (pair_g2.cuh).
//
// Replaces the G2 instance of jac_scan.cu's k_jac_scan (one thread a lane,
// 128 threads a block; every Fq2 product an out-of-line call through
// pointers, so each operand went through local memory: a 2,976-B frame a
// thread), which stands in for jac_scan_pallas (zukelang_tpu/ops/
// pallas_kernels.py:986) on G2.  The contract is that kernel's, word for
// word: the same arguments, the (2, 12, n) layout, chunk m at columns
// m K .. m K + K - 1, the restarts where seg changes, and the same three
// phases with the same additions in the same order (jac_scan.cu's note):
// each lane sums its L = K / g points, a Hillis-Steele scan over the g
// lane totals with the segmented operator, and each lane scans its points
// again from lane l - 1's prefix.
//
// Bound: the full adds, 48 Fq products each in the one-thread form
// (add-2007-bl, 16 Fq2 products by Karatsuba), against the card's rate of
// limb products; at one thread a chunk the 2^20 prove's 16,384 chunks
// were also four warps an SM, each a chain of 31 adds.
//
// Design: lane l of a group is threads 2l and 2l + 1, so a group of g
// lanes is 2g threads and g is at most 16.  Each thread keeps its
// component of the lane's running sum in a slot of shared memory (36
// words, word j of a coordinate at j times the block's threads, so the
// threads of a warp hit distinct banks); pair_add reads its operands from
// the slot and from the input columns where it multiplies them, and only
// its temporaries live in registers.  The Hillis-Steele scan reads lane
// l - d's slot in place of shuffling its 36 words: a __syncwarp before
// the reads of a round and one before its writes.  Lane l - 1's prefix is
// copied to a second slot, the carry, before the rescan overwrites the
// first.
// Registers, as measured on the H100 (PERF.md, section 6): with the
// products out of line by value (pair_g2.cuh's pmul, pair_sqr) and p's
// limbs as immediates, 128 threads x 3 blocks an SM (12 warps) compile to
// 168 registers with no stack and no spill; the one-thread kernel had 228
// registers and a 2,976-B frame.  With p in registers the kernel spilled
// 200 B at this cap; with the products inlined it spilled and ran about
// 2x slower (likely the instruction cache: each add site then holds its
// own copy of 16 products); 8 warps (no spill, 184-200 registers) ran 1 %
// faster at 2^20 and 11 % slower in the Pinocchio cell; 16 warps spilled.
// The grid covers 2 g threads a chunk, the last block's idle pairs masked
// by `live`.
#include "pair_g2.cuh"

namespace zk {

constexpr int kScanG2T = 128;
constexpr int kScanG2BlocksPerSM = 3;

__global__ void __launch_bounds__(kScanG2T, kScanG2BlocksPerSM)
k_jac_scan_g2(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z,
              const int32_t* __restrict__ seg, uint32_t* ox, uint32_t* oy,
              uint32_t* oz, int K, int g, int64_t n) {
  // two slots (the running sum, the carry) of 36 words a thread
  __shared__ uint32_t slots[2 * 36 * kScanG2T];
  const uint32_t h = threadIdx.x & 1u;
  const unsigned m = pair_mask();
  const int64_t M = n / K;
  const int64_t l = ((int64_t)blockIdx.x * kScanG2T + threadIdx.x) >> 1;
  const int64_t ch = l / g;
  const int lane = (int)(l & (g - 1));
  const bool live = ch < M;       // a group is live or idle as a whole
  const int L = K / g;
  const int64_t first = ch * K;
  const int64_t base = first + (int64_t)lane * L;
  // this thread's component: rows 12 h .. 12 h + 11 of each coordinate
  x += (int64_t)(12 * h) * n;
  y += (int64_t)(12 * h) * n;
  z += (int64_t)(12 * h) * n;
  uint32_t* acc = slots + threadIdx.x;
  uint32_t* carry = acc + 36 * kScanG2T;
  auto slot = [&](const uint32_t* s) {
    return PairPt{s, s + 12 * kScanG2T, s + 24 * kScanG2T, kScanG2T};
  };
  auto col_pt = [&](int64_t col) {
    return PairPt{x + col, y + col, z + col, n};
  };
  auto put = [&](uint32_t* s, const PairJac& p) {
    pair_st(s, kScanG2T, p.X);
    pair_st(s + 12 * kScanG2T, kScanG2T, p.Y);
    pair_st(s + 24 * kScanG2T, kScanG2T, p.Z);
  };
  // the sum restarts at the chunk's first point and where seg changes
  auto restart = [&](int64_t col) {
    return col == first || (seg != nullptr && seg[col] != seg[col - 1]);
  };
  PairJac p;
  if (g > 1) {
    bool f = false;
    if (live) {
#pragma unroll 1
      for (int t = 0; t < L; ++t) {
        const bool rs = restart(base + t);
        if (t == 0 || rs)
          pair_ld_point(p, col_pt(base + t));
        else
          pair_add(p, slot(acc), col_pt(base + t), h, m);
        put(acc, p);
        f = f || rs;
      }
    } else {
      h_one_or_zero(p.X, false, h);
      p.Y = p.Z = p.X;
      put(acc, p);
    }
#pragma unroll 1
    for (int d = 1; d < g; d <<= 1) {
      const bool fo = __shfl_up_sync(0xffffffffu, (int)f, 2 * d, 2 * g) != 0;
      const bool add = lane >= d && !f;
      __syncwarp();
      if (add) pair_add(p, slot(acc - 2 * d), slot(acc), h, m);
      __syncwarp();
      if (add) put(acc, p);
      if (lane >= d) f = f || fo;
    }
    __syncwarp();
    if (lane > 0) {                          // lane 0 restarts at its first
      pair_ld_point(p, slot(acc - 2));
      put(carry, p);
    }
    __syncwarp();
  }
  if (!live) return;
#pragma unroll 1
  for (int t = 0; t < L; ++t) {
    const int64_t col = base + t;
    if (restart(col))
      pair_ld_point(p, col_pt(col));
    else
      pair_add(p, slot(t == 0 ? carry : acc), col_pt(col), h, m);
    put(acc, p);
    h_store(ox, col, n, h, p.X);
    h_store(oy, col, n, h, p.Y);
    h_store(oz, col, n, h, p.Z);
  }
}

int launch_jac_scan_g2(const void* x, const void* y, const void* z,
                       const void* seg, void* ox, void* oy, void* oz, int K,
                       int g, int64_t n, cudaStream_t s) {
  k_jac_scan_g2<<<blocks_for(2 * (n / K) * g, kScanG2T), kScanG2T, 0, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const int32_t*)seg, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, K, g,
      n);
  return (int)cudaGetLastError();
}

}  // namespace zk
