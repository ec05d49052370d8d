// K7: chunked inclusive Jacobian prefix sum with the full group law and an
// optional restart at segment boundaries.  Replaces jac_scan_pallas
// (zukelang_tpu/ops/pallas_kernels.py:986; kernel _jac_scan_kernel :866,
// call _jac_scan_call :961).  This kernel runs G1; G2 runs on thread pairs
// (jac_scan_g2.cu), with the same contract and order of additions.
//
// Coordinates are flat (rows, n); chunk m is columns [m*K, m*K + K).  With
// seg (n,) the sum restarts where seg[c] != seg[c - 1] inside the chunk.
//
// Bound: on the card, latency.  A full add is a chain of 16 coordinate
// products (48 Fq products for G2), and the provers' scans have 40 to
// 5,120 chunks: at one thread a chunk, a chain of K - 1 dependent adds on
// a card that is nearly empty.
//
// Design: a group of g lanes (g a power of two dividing K and 32, from
// `kernels.jac_scan_group`) shares a chunk; lane l takes the L = K / g
// consecutive points l L .. l L + L - 1.  Reduce, then scan:
//   1. each lane sums its points from its last restart on (L - 1 adds)
//      and notes whether it holds a restart, f;
//   2. a Hillis-Steele scan over the g lane totals with shuffles, with the
//      segmented operator (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2)
//      (log2 g adds), gives each lane the prefix up to its last point;
//   3. each lane scans its points again from lane l - 1's prefix, the
//      carry-in, which holds until its first restart (L adds).
// A chunk's chain is 2L - 1 + log2 g adds: 6 at g = 32 against K - 1 =
// 31 at g = 1 (step 1 and 2 are skipped there).  Jacobian words depend on
// the order of the additions, so the plain version (`jac_scan_plain`)
// adds in this order for the same g; at g = 1 it is the sequential scan.
#include "curve.cuh"

namespace zk {

constexpr int kScanThreads = 128;

template <class G>
__global__ void __launch_bounds__(kScanThreads)
k_jac_scan(const uint32_t* x, const uint32_t* y, const uint32_t* z,
           const int32_t* seg, uint32_t* ox, uint32_t* oy, uint32_t* oz,
           int K, int g, int64_t n) {
  const int64_t M = n / K;
  const int64_t m = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / g;
  const int lane = threadIdx.x & (g - 1);
  const bool live = m < M;        // a group is live or idle as a whole
  const int L = K / g;
  const int64_t base = m * K + (int64_t)lane * L;
  // the accumulator restarts at the chunk's first point and where seg
  // changes
  auto restart = [&](int64_t col) {
    return col == m * K || (seg != nullptr && seg[col] != seg[col - 1]);
  };
  Jac<G> acc, cur, carry;
  if (g > 1) {
    bool f = false;
    if (live) {
      for (int t = 0; t < L; ++t) {
        jac_load<G>(cur, x, y, z, base + t, n);
        const bool rs = restart(base + t);
        if (t == 0 || rs)
          acc = cur;
        else
          jac_add<G>(acc, acc, cur);
        f = f || rs;
      }
    } else {
      G::set_zero(acc.X);
      G::set_zero(acc.Y);
      G::set_zero(acc.Z);
    }
    for (int d = 1; d < g; d <<= 1) {
      Jac<G> o;
      jac_shfl_up<G>(o, acc, d, g);
      const bool fo = __shfl_up_sync(0xffffffffu, (int)f, d, g) != 0;
      if (lane >= d) {
        if (!f) jac_add<G>(acc, o, acc);
        f = f || fo;
      }
    }
    jac_shfl_up<G>(carry, acc, 1, g);        // lane l - 1's prefix
  }
  if (!live) return;
  for (int t = 0; t < L; ++t) {
    const int64_t col = base + t;
    jac_load<G>(cur, x, y, z, col, n);
    if (restart(col))
      acc = cur;
    else if (t == 0)
      jac_add<G>(acc, carry, cur);
    else
      jac_add<G>(acc, acc, cur);
    jac_store<G>(ox, oy, oz, col, n, acc);
  }
}

// K7 for G2 on thread pairs (jac_scan_g2.cu).
int launch_jac_scan_g2(const void* x, const void* y, const void* z,
                       const void* seg, void* ox, void* oy, void* oz, int K,
                       int g, int64_t n, cudaStream_t s);

}  // namespace zk

// g: lanes per chunk, a power of two dividing K and 32 (G2: 16, a group's
// thread pairs within a warp).
extern "C" int zk_jac_scan(int g2, const void* x, const void* y,
                           const void* z, const void* seg, void* ox, void* oy,
                           void* oz, int K, int g, int64_t n, void* stream) {
  if (g < 1 || g > (g2 ? 16 : 32) || (g & (g - 1)) || K % g)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_jac_scan_g2(x, y, z, seg, ox, oy, oz, K, g, n, s);
  zk::k_jac_scan<zk::G1Field>
      <<<zk::blocks_for(n / K * g, zk::kScanThreads), zk::kScanThreads, 0,
         s>>>((const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
              (const int32_t*)seg, (uint32_t*)ox, (uint32_t*)oy,
              (uint32_t*)oz, K, g, n);
  return (int)cudaGetLastError();
}
