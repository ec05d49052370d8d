// K6 for G2 on thread pairs: k_weighted_sums (weighted_sums.cu) over G2
// points, each chunk lane held by two adjacent threads, one Fq component
// of every Fq2 coordinate each (pair_g2.cuh).
//
// Replaces the G2 instance of weighted_sums.cu's k_weighted_sums (one
// thread a lane, 128 threads a block; every Fq2 product an out-of-line
// call through pointers, so each operand went through local memory),
// which stands in for weighted_chunk_sums (zukelang_tpu/ops/
// pallas_kernels.py:1455) on G2.  The contract is that kernel's, word for
// word: per chunk of K points s = sum_t v_t and w = sum_t t v_t, in the
// (2, 12, n) layout, with the same additions in the same order
// (weighted_sums.cu's note): lane i's reversed scan of the points
// i + j g, the suffix scan of the S_i, log2 g doublings of W_i and one
// add, the suffix scan of the Y_i, lane 0's stores.
//
// Bound: the full adds, 48 Fq products each in the one-thread form
// (add-2007-bl, 16 Fq2 products by Karatsuba), against the card's rate of
// limb products: at 2^20 the level-1 launch's two adds a point are
// 1.45e10 limb products.
//
// Design: lane i of a group is threads 2i and 2i + 1, so a group of g
// lanes is 2g threads and g is at most 16.  Each thread keeps its
// components of S_i and W_i in two slots of shared memory (36 words each,
// word j of a coordinate at j times the block's threads, so the threads of
// a warp hit distinct banks); pair_add reads its operands from the slots
// and from the input columns where it multiplies them, and only its
// temporaries live in registers.  A suffix scan reads lane i + d's slot
// in place of shuffling its 36 words: a __syncwarp before the reads of a
// round and one before its writes.  Y_i takes W_i's slot.
// Registers, as measured on the H100 (PERF.md, section 6): 128 threads x
// 3 blocks an SM (12 warps) compile to 167 registers with no stack and no
// spill (jac_scan_g2.cu gives the variants tried); the one-thread kernel
// had 230 registers and a 3,264-B frame.  The grid covers 2 g threads a
// chunk, the last block's idle pairs masked by `live`.
#include "pair_g2.cuh"

namespace zk {

constexpr int kWsumG2T = 128;
constexpr int kWsumG2BlocksPerSM = 3;

__global__ void __launch_bounds__(kWsumG2T, kWsumG2BlocksPerSM)
k_weighted_sums_g2(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z, uint32_t* sx,
                   uint32_t* sy, uint32_t* sz, uint32_t* wx, uint32_t* wy,
                   uint32_t* wz, int K, int g, int log_g, int64_t n) {
  // two slots (S_i, then W_i and Y_i) of 36 words a thread, and a zero
  __shared__ uint32_t slots[2 * 36 * kWsumG2T + 1];
  const uint32_t h = threadIdx.x & 1u;
  const unsigned m = pair_mask();
  const int64_t M = n / K;
  const int64_t l = ((int64_t)blockIdx.x * kWsumG2T + threadIdx.x) >> 1;
  const int64_t ch = l / g;
  const int lane = (int)(l & (g - 1));
  const bool live = ch < M;       // a group is live or idle as a whole
  const int L = K / g;
  const int64_t off = (int64_t)(12 * h) * n;
  uint32_t* s = slots + threadIdx.x;
  uint32_t* w = s + 36 * kWsumG2T;
  uint32_t* zero = slots + 2 * 36 * kWsumG2T;
  if (threadIdx.x == 0) *zero = 0;
  __syncthreads();
  auto slot = [&](const uint32_t* a) {
    return PairPt{a, a + 12 * kWsumG2T, a + 24 * kWsumG2T, kWsumG2T};
  };
  auto col_pt = [&](int64_t col) {
    return PairPt{x + off + col, y + off + col, z + off + col, n};
  };
  auto put = [&](uint32_t* a, const PairJac& p) {
    pair_st(a, kWsumG2T, p.X);
    pair_st(a + 12 * kWsumG2T, kWsumG2T, p.Y);
    pair_st(a + 24 * kWsumG2T, kWsumG2T, p.Z);
  };
  const PairPt nil{zero, zero, zero, 0};
  PairJac p;
  if (live) {
#pragma unroll 1
    for (int j = L - 1; j >= 0; --j) {
      const int64_t col = ch * K + lane + (int64_t)j * g;
      if (j == L - 1)
        pair_ld_point(p, col_pt(col));
      else
        pair_add(p, slot(s), col_pt(col), h, m);
      put(s, p);
      if (j >= 1) {
        if (j < L - 1) pair_add(p, slot(w), slot(s), h, m);
        put(w, p);
      }
    }
  } else {
    pair_ld_point(p, nil);
    put(s, p);
  }
  if (!live || L == 1) {
    pair_ld_point(p, nil);
    put(w, p);
  }
  // suffix sums over the group's lanes: lane i ends with S_i + S_(i+1) +
  // ... + S_(g-1), added as S_i + (the lanes above)
  auto suffix_scan = [&](uint32_t* a) {
#pragma unroll 1
    for (int d = 1; d < g; d <<= 1) {
      const bool add = lane + d < g;
      __syncwarp();
      if (add) pair_add(p, slot(a), slot(a + 2 * d), h, m);
      __syncwarp();
      if (add) put(a, p);
    }
  };
  suffix_scan(s);                            // s = Suf_lane
  // Y_i = [i >= 1] Suf_i + g W_i, in W_i's slot
  if (L > 1) {
#pragma unroll 1
    for (int k = 0; k < log_g; ++k) {
      pair_dbl(p, slot(w), h, m);
      put(w, p);
    }
    pair_add(p, lane >= 1 ? slot(s) : nil, slot(w), h, m);
  } else {
    pair_ld_point(p, lane >= 1 ? slot(s) : nil);
  }
  put(w, p);
  suffix_scan(w);                            // lane 0: w
  if (live && lane == 0) {
    pair_ld_point(p, slot(s));
    h_store(sx, ch, M, h, p.X);
    h_store(sy, ch, M, h, p.Y);
    h_store(sz, ch, M, h, p.Z);
    pair_ld_point(p, slot(w));
    h_store(wx, ch, M, h, p.X);
    h_store(wy, ch, M, h, p.Y);
    h_store(wz, ch, M, h, p.Z);
  }
}

int launch_weighted_sums_g2(const void* x, const void* y, const void* z,
                            void* sx, void* sy, void* sz, void* wx, void* wy,
                            void* wz, int K, int g, int log_g, int64_t n,
                            cudaStream_t s) {
  k_weighted_sums_g2<<<blocks_for(2 * (n / K) * g, kWsumG2T), kWsumG2T, 0,
                       s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)sx, (uint32_t*)sy, (uint32_t*)sz, (uint32_t*)wx,
      (uint32_t*)wy, (uint32_t*)wz, K, g, log_g, n);
  return (int)cudaGetLastError();
}

}  // namespace zk
