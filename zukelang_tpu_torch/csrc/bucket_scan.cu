// K5 and K8: segmented running mixed adds over sorted, sign-applied affine
// points, one thread per chunk lane with the accumulator and the collision
// flag in registers (the Pallas grid's sequential t axis).  Both share
// jac_madd<G>'s formula (curve.cuh).
//
// K5 replaces bucket_scan_rows (zukelang_tpu/ops/pallas_kernels.py:1296;
// kernel _seg_scan_kernel2 :1192, call _seg_scan2_call :1253).  The Pallas
// kernel takes its points already gathered and relaid out as (K, 2 rows,
// M) and writes every step's accumulator; on the card that costs two
// copies of the gathered rows and a (K, rows, M) output of which the MSM
// reads only the chunk ends and one column per bucket.  Here the kernel
// gathers: lane (chunk) m of block row b takes, at step t, the row
// idx[b, m K + t] of the table `rows` (Nrows, 2 rows) of affine [X; Y]
// points ((0, 0) = infinity), and the accumulator restarts at t = 0 and
// where the sorted segment id changes (seg null: one segment per chunk).
// A block first stages its lanes' K indices and segment ids in shared
// memory with coalesced loads (rows padded to K + 1 words, so the lanes'
// reads hit distinct banks); each lane then loads its 96 B (G1) or 192 B
// (G2) row per step with 16-byte loads.  It writes each chunk's final
// accumulator (tails, (rows, lanes)) and, with nb, each bucket's in-chunk
// tail: at the step where the segment ends (the digit changes, or the
// block row ends), the accumulator goes to column b nb + seg of the
// (rows, B nb) bucket outputs, which the wrapper zero-fills.
// Bound: the 11 Fq products (x3 for G2) of each continuing step with both
// operands finite.  The madd is inlined; its field products are the
// coordinate fields' out-of-line calls (inlined, G1's were no faster and
// G2's spilled 1.8 KB at the register cap).  Blocks are sized so the card
// holds the Groth16 prove's 40,960 G2 lanes in one wave (5 blocks of 64
// per SM) and the 163,840 G1 lanes in whole waves (4 blocks of 128).
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

// The affine point of one table row: G1 [X (12); Y (12)], G2 [X.c0; X.c1;
// Y.c0; Y.c1] (12 words each), read with 16-byte loads.
template <class G>
__device__ __forceinline__ void load_row(typename G::E& x, typename G::E& y,
                                         const uint32_t* row) {
  constexpr int W = 2 * G::ROWS;
  uint32_t w[W];
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 v = __ldg(q + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
  uint32_t* ys = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int j = 0; j < G::ROWS; ++j) {
    xs[j] = w[j];
    ys[j] = w[G::ROWS + j];
  }
}

// Lane (chunk) l = b M + m covers positions l K .. l K + K - 1 of the
// (B, n) idx / seg arrays, n = M K.  T threads a block, at least
// `BlocksPerSM` blocks an SM (the register cap).
template <class G, int T, int BlocksPerSM>
__global__ void __launch_bounds__(T, BlocksPerSM)
k_bucket_scan_rows(const uint32_t* __restrict__ rows,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ seg, uint32_t* tx,
                   uint32_t* ty, uint32_t* tz, uint32_t* bx, uint32_t* by,
                   uint32_t* bz, int32_t* flag, int K, int64_t lanes,
                   int64_t M, int nb) {
  extern __shared__ int32_t staged[];
  const int KP = K + 1;
  int32_t* s_idx = staged;
  int32_t* s_seg = staged + T * KP;
  const int64_t lane0 = (int64_t)blockIdx.x * T;
  const int nl = (int)min((int64_t)T, lanes - lane0);
  const int64_t first = lane0 * K;
  for (int i = threadIdx.x; i < nl * K; i += T) {
    const int l = i / K;
    const int at = l * KP + i - l * K;
    s_idx[at] = idx[first + i];
    if (seg) s_seg[at] = seg[first + i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= nl) return;
  const int64_t lane = lane0 + threadIdx.x;
  const int32_t* my_idx = s_idx + threadIdx.x * KP;
  const int32_t* my_seg = s_seg + threadIdx.x * KP;
  // the segment id after the chunk's last step: the next chunk's first in
  // the same block row, else -1 (the row ends)
  const int64_t b = lane / M;
  const int32_t after =
      nb && lane % M + 1 < M ? seg[(lane + 1) * K] : -1;
  const int64_t ncols = lanes / M * nb;
  constexpr int W = 2 * G::ROWS;
  using E = typename G::E;
  Jac<G> acc;
  bool collided = false;
  for (int t = 0; t < K; ++t) {
    E cx, cy;
    load_row<G>(cx, cy, rows + (int64_t)my_idx[t] * W);
    if (t > 0 && (!seg || my_seg[t] == my_seg[t - 1])) {
      bool same;
      jac_madd_inl<G>(acc, same, acc, cx, cy);
      collided |= same;
    } else {
      acc.X = cx;
      acc.Y = cy;
      if (G::is_zero(cx) && G::is_zero(cy))
        G::set_zero(acc.Z);
      else
        G::set_one(acc.Z);
    }
    if (nb) {
      const int32_t d = my_seg[t];
      if ((t + 1 < K ? my_seg[t + 1] : after) != d && d >= 0 && d < nb)
        jac_store<G>(bx, by, bz, b * nb + d, ncols, acc);
    }
  }
  jac_store<G>(tx, ty, tz, lane, lanes, acc);
  flag[lane] = collided ? 1 : 0;
}

template <class G, int T, int BlocksPerSM>
int launch_scan_rows(const void* rows, const void* idx, const void* seg,
                     void* tx, void* ty, void* tz, void* bx, void* by,
                     void* bz, void* flag, int K, int64_t lanes, int64_t M,
                     int nb, cudaStream_t s) {
  const size_t smem = (size_t)T * (K + 1) * sizeof(int32_t) * (seg ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k_bucket_scan_rows<G, T, BlocksPerSM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_bucket_scan_rows<G, T, BlocksPerSM>
      <<<blocks_for(lanes, T), T, smem, s>>>(
      (const uint32_t*)rows, (const int32_t*)idx, (const int32_t*)seg,
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, (int32_t*)flag, K, lanes, M, nb);
  return (int)cudaGetLastError();
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

// rows (Nrows, 2 rows) 16-byte aligned; idx, seg (lanes / M, M K) int32,
// seg null for one segment per chunk; nb > 0 needs seg with ids in
// [0, nb).  Outputs: tails (rows, lanes), buckets (rows, lanes / M * nb)
// when nb > 0, flag (lanes,).
extern "C" int zk_bucket_scan_rows(int g2, const void* rows, const void* idx,
                                   const void* seg, void* tx, void* ty,
                                   void* tz, void* bx, void* by, void* bz,
                                   void* flag, int K, int64_t lanes,
                                   int64_t M, int nb, void* stream) {
  if (K < 1 || M < 1 || lanes % M || (nb && !seg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_scan_rows<zk::G2Field, 64, 5>(
        rows, idx, seg, tx, ty, tz, bx, by, bz, flag, K, lanes, M, nb, s);
  return zk::launch_scan_rows<zk::G1Field, 128, 4>(
      rows, idx, seg, tx, ty, tz, bx, by, bz, flag, K, lanes, M, nb, s);
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
