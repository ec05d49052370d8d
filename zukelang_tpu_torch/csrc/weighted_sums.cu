// K6: per chunk of K Jacobian points, s = sum_t v_t and w = sum_t t * v_t.
// Replaces weighted_chunk_sums (zukelang_tpu/ops/pallas_kernels.py:1455;
// kernel _wsum_kernel :1327, call _wsum_call :1430).
//
// Bound: on the card, latency.  Each full add is a chain of 16 coordinate
// products (48 Fq products for G2), and the launches are narrow: the
// weighted reduce's levels have 80 to 20,640 chunks.  One thread per chunk
// is a chain of 2K - 3 dependent adds and, below one wave, the launch lasts
// as long as that chain.
//
// Design: a group of g lanes (g a power of two dividing K and 32) works on
// one chunk, g picked by the wrapper from the chunk count.  Lane i takes
// the points t = i + j g (j < L = K / g): neighbouring lanes load
// neighbouring columns, so the loads are coalesced.  Each lane runs the
// reversed scan of its L points in registers (S_i = sum_j v, W_i =
// sum_j j v: 2L - 3 adds).  Then, with t = i + j g,
//     s = sum_i S_i,    w = sum_i i S_i + g sum_i W_i,
// and sum_i i S_i = sum_{i>=1} Suf_i over the suffix sums Suf_i =
// sum_{i'>=i} S_i'.  The group forms Suf_i by a shuffle suffix scan
// (log2 g adds), Y_i = [i >= 1] Suf_i + g W_i (log2 g doublings, one add;
// nothing for L = 1, where W_i = 0), and w = the sum of the Y_i by a
// second suffix scan; lane 0 writes s = Suf_0 and w.  A chunk's chain is
// 2L - 3 + 2 log2 g adds plus the doublings: 10 adds at g = 32 against 61
// at g = 1.  The plain version (`weighted_chunk_sums_plain`) makes the
// same additions in the same order, so the two agree word for word.
#include "curve.cuh"

namespace zk {

constexpr int kWsumThreads = 128;

template <class G>
__device__ __forceinline__ void jac_shfl_down(Jac<G>& out, const Jac<G>& p,
                                              int d, int g) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&p);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Jac<G>) / 4); ++k)
    dst[k] = __shfl_down_sync(0xffffffffu, src[k], d, g);
}

template <class G>
__device__ __forceinline__ void jac_zero(Jac<G>& p) {
  G::set_zero(p.X);
  G::set_zero(p.Y);
  G::set_zero(p.Z);
}

// Inclusive suffix sums over the g lanes of a group: lane i ends with
// p_i + p_{i+1} + ... + p_{g-1}, added as p_i + (the lanes above).
template <class G>
__device__ __forceinline__ void group_suffix_scan(Jac<G>& p, int lane, int g) {
  for (int d = 1; d < g; d <<= 1) {
    Jac<G> o;
    jac_shfl_down<G>(o, p, d, g);
    if (lane + d < g) jac_add<G>(p, p, o);
  }
}

template <class G>
__global__ void __launch_bounds__(kWsumThreads)
k_weighted_sums(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                uint32_t* sx, uint32_t* sy, uint32_t* sz, uint32_t* wx,
                uint32_t* wy, uint32_t* wz, int K, int g, int log_g,
                int64_t n) {
  const int64_t M = n / K;
  const int64_t m = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / g;
  const int lane = threadIdx.x & (g - 1);
  const bool live = m < M;        // a group is live or idle as a whole
  const int L = K / g;
  Jac<G> s, w, v;
  jac_zero<G>(w);
  for (int j = L - 1; j >= 0; --j) {
    if (live)
      jac_load<G>(v, x, y, z, m * K + lane + (int64_t)j * g, n);
    else
      jac_zero<G>(v);
    if (j == L - 1)
      s = v;
    else
      jac_add<G>(s, s, v);
    if (j >= 1) {
      if (j == L - 1)
        w = s;
      else
        jac_add<G>(w, w, s);
    }
  }
  group_suffix_scan<G>(s, lane, g);          // s = Suf_lane
  Jac<G> t;
  if (lane >= 1)
    t = s;
  else
    jac_zero<G>(t);
  if (L > 1) {
    for (int k = 0; k < log_g; ++k) jac_double<G>(w, w);
    jac_add<G>(t, t, w);
  }
  group_suffix_scan<G>(t, lane, g);          // lane 0: w
  if (live && lane == 0) {
    jac_store<G>(sx, sy, sz, m, M, s);
    jac_store<G>(wx, wy, wz, m, M, t);
  }
}

}  // namespace zk

// g: lanes per chunk, a power of two dividing K and 32.
extern "C" int zk_weighted_chunk_sums(int g2, const void* x, const void* y,
                                      const void* z, void* sx, void* sy,
                                      void* sz, void* wx, void* wy, void* wz,
                                      int K, int g, int64_t n, void* stream) {
  if (g < 1 || g > 32 || (g & (g - 1)) || K % g)
    return (int)cudaErrorInvalidValue;
  const int log_g = __builtin_ctz((unsigned)g);
  const unsigned blocks = zk::blocks_for(n / K * g, zk::kWsumThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_weighted_sums<zk::G2Field><<<blocks, zk::kWsumThreads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
        (uint32_t*)sx, (uint32_t*)sy, (uint32_t*)sz, (uint32_t*)wx,
        (uint32_t*)wy, (uint32_t*)wz, K, g, log_g, n);
  else
    zk::k_weighted_sums<zk::G1Field><<<blocks, zk::kWsumThreads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
        (uint32_t*)sx, (uint32_t*)sy, (uint32_t*)sz, (uint32_t*)wx,
        (uint32_t*)wy, (uint32_t*)wz, K, g, log_g, n);
  return (int)cudaGetLastError();
}
