// K5 and K8: segmented running mixed adds over sorted, sign-applied affine
// points, one thread per chunk lane with the accumulator and the collision
// flag in registers (the Pallas grid's sequential t axis).  Both share
// jac_madd<G>, G::load and jac_store (curve.cuh).
//
// K5 replaces bucket_scan_rows (zukelang_tpu/ops/pallas_kernels.py:1296;
// kernel _seg_scan_kernel2 :1192, call _seg_scan2_call :1253).
// pts (K, 2*rows, M): step t of lane m is the affine point [X; Y] at
// column m; (0, 0) is infinity.  seg / segp (K, M): the accumulator
// restarts at step t unless seg == segp.  tails_only keeps just the final
// accumulator (out shape (1, rows, M) instead of (K, rows, M)).
//
// K8 replaces bucket_scan_pallas (pallas_kernels.py:807; kernel
// _seg_scan_kernel :709, call _seg_scan_call :778).  X and Y stay in the
// flat (rows, N) layout: lane m reads element m*K + t in place, and
// compares seg with its predecessor itself, so there is neither the
// Pallas (K, rows, M) relayout nor a segp input nor block padding.  Bound:
// 11 Fq products (x3 for G2) per continuing step with both operands
// finite, against reading X, Y and seg and writing X, Y and Z.  The
// stride-K read is not coalesced (neighbouring lanes are K columns apart);
// staging a block's chunks through shared memory would fix that.
#include "curve.cuh"

namespace zk {

template <class G>
__global__ void __launch_bounds__(128)
k_bucket_scan_rows(const uint32_t* __restrict__ pts,
                   const int32_t* __restrict__ seg,
                   const int32_t* __restrict__ segp, uint32_t* ox,
                   uint32_t* oy, uint32_t* oz, int32_t* flag, int K,
                   int64_t M, int tails_only) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  constexpr int R = G::ROWS;
  using E = typename G::E;
  Jac<G> acc;
  bool collided = false;
  for (int t = 0; t < K; ++t) {
    E cx, cy;
    const uint32_t* base = pts + (int64_t)t * 2 * R * M + m;
    G::load(cx, base, M);
    G::load(cy, base + (int64_t)R * M, M);
    const bool cont = t > 0 && seg[(int64_t)t * M + m] == segp[(int64_t)t * M + m];
    if (cont) {
      bool same;
      jac_madd<G>(acc, same, acc, cx, cy);
      collided |= same;
    } else {
      acc.X = cx;
      acc.Y = cy;
      if (G::is_zero(cx) && G::is_zero(cy))
        G::set_zero(acc.Z);
      else
        G::set_one(acc.Z);
    }
    if (!tails_only || t == K - 1) {
      const int64_t o = (tails_only ? 0 : (int64_t)t * R * M) + m;
      jac_store<G>(ox, oy, oz, o, M, acc);
    }
  }
  flag[m] = collided ? 1 : 0;
}


// K8: lane m walks columns m*K .. m*K+K-1 of the flat (rows, n) layout.
template <class G>
__global__ void __launch_bounds__(128)
k_bucket_scan(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const int32_t* __restrict__ seg, uint32_t* ox, uint32_t* oy,
              uint32_t* oz, int32_t* flag, int K, int64_t n) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n / K) return;
  using E = typename G::E;
  Jac<G> acc;
  bool collided = false;
  for (int t = 0; t < K; ++t) {
    const int64_t col = m * K + t;
    E cx, cy;
    G::load(cx, x + col, n);
    G::load(cy, y + col, n);
    if (t > 0 && seg[col] == seg[col - 1]) {
      bool same;
      jac_madd<G>(acc, same, acc, cx, cy);
      collided |= same;
    } else {
      acc.X = cx;
      acc.Y = cy;
      if (G::is_zero(cx) && G::is_zero(cy))
        G::set_zero(acc.Z);
      else
        G::set_one(acc.Z);
    }
    jac_store<G>(ox, oy, oz, col, n, acc);
  }
  flag[m] = collided ? 1 : 0;
}

}  // namespace zk

extern "C" int zk_bucket_scan_rows(int g2, const void* pts, const void* seg,
                                   const void* segp, void* ox, void* oy,
                                   void* oz, void* flag, int K, int64_t M,
                                   int tails_only, void* stream) {
  const unsigned blocks = zk::blocks_for(M, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_bucket_scan_rows<zk::G2Field><<<blocks, 128, 0, s>>>(
        (const uint32_t*)pts, (const int32_t*)seg, (const int32_t*)segp,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, K, M,
        tails_only);
  else
    zk::k_bucket_scan_rows<zk::G1Field><<<blocks, 128, 0, s>>>(
        (const uint32_t*)pts, (const int32_t*)seg, (const int32_t*)segp,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, K, M,
        tails_only);
  return (int)cudaGetLastError();
}

// x, y: (rows, n) affine coordinates; seg (n,) sorted; n % K == 0.
extern "C" int zk_bucket_scan(int g2, const void* x, const void* y,
                              const void* seg, void* ox, void* oy, void* oz,
                              void* flag, int K, int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n / K, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_bucket_scan<zk::G2Field><<<blocks, 128, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)seg,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, K, n);
  else
    zk::k_bucket_scan<zk::G1Field><<<blocks, 128, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)seg,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, K, n);
  return (int)cudaGetLastError();
}
