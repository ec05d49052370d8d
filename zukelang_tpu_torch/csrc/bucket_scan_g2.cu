// K5 for G2 on thread pairs: the segmented running mixed adds of
// bucket_scan_rows (bucket_scan.cu) over G2 rows, each chunk lane held by
// two adjacent threads, one Fq component of every Fq2 coordinate each.
//
// Replaces the G2 instance of bucket_scan.cu's k_bucket_scan_rows (one
// thread a lane, 64 threads x 5 blocks an SM: 10 warps; 168 registers
// and 670 B spilled, every Fq2 product an out-of-line call through local
// memory), which stands in for bucket_scan_rows (zukelang_tpu/ops/
// pallas_kernels.py:1296) on G2.  The contract is that kernel's, word for
// word: the same arguments and row table, the same restarts, tails and
// bucket tails in the (2, 12, lanes) layout, the same collision flag.
//
// Bound: the Fq products of each continuing step with both operands
// finite, against the card's rate of limb products: 33 Fq products a
// step in the one-thread form (madd-2007-bl, 11 Fq2 products by
// Karatsuba).  One thread cannot hold a G2 Jacobian accumulator (72
// words), an affine row (48) and the madd's temporaries without spilling
// at an occupancy that hides the products' latency.
//
// Design: threads 2j and 2j + 1 of a warp own chunk lane j; thread h
// holds component h of X, Y, Z, of the gathered row (its 48 B, loaded
// with 16-byte loads) and of each temporary, so a pair carries one lane
// in the registers that the one-thread form needed per thread.  Sums and
// differences are per component.  An Fq2 product a b splits evenly over
// the pair with lazy reduction: thread 0 forms
//   c0 = REDC(a0 b0 + a1 (p - b1)),
// thread 1 forms
//   c1 = REDC(a1 b0 + a0 b1),
// each two 12 x 12 products summed into one Montgomery reduction (one
// CIOS pass over both: 432 limb products a thread, 864 a pair, Karatsuba's
// three Fq products).  Both sums are below 2 p^2 < p 2^384, so the pass
// ends below 2p and one conditional subtraction gives the canonical
// value.  A square splits as (a0 + a1)(a0 - a1) on thread 0 and 2 a0 a1
// on thread 1: one Fq product a thread.  The partner's component of one
// operand comes by one shuffle a word, the other's limb by limb inside the
// pass.  The madd computes Z3 = 2 Z H, which equals madd-2007-bl's
// (Z + H)^2 - Z1Z1 - HH in the field, so Z1Z1 dies early (8 products and
// 3 squares a step: 4,320 limb products a thread, against 4,752 for each
// of two threads sharing Karatsuba's 33 Fq products).  Every result is
// canonical, so the words are the one-thread formula's, garbage of a
// flagged lane included.  Predicates over an Fq2 value (the infinity
// tests, the madd's doubling case) are one shuffle: both threads of a
// pair read the same idx and seg, so they always branch alike, and every
// shuffle names only its pair.
// Registers, as measured on the H100 (PERF.md, section 6): the products
// are inlined PTX carry chains (field.cuh's cios_mac, pair_g2.cuh's
// cios_redc_imm) and the square one out-of-line call by value, so 128
// threads x 3 blocks an SM (12 warps) compile to 167 registers (168 since
// the reduction takes p as immediates, at the same speed) with no stack
// and no spill.  The
// same products in 64-bit C arithmetic ran 6 % faster but spilled
// 60-182 B at that cap; 16 warps (128 registers) spilled 188-1,002 B and
// ran 1.1-1.8x slower.  At 12 warps no block size puts a 2^16 prove's
// 40,960 lanes in one wave (that needs 20); blocks of 32 and of 64 lanes
// ran equal there, so the grid is simply ceil(lanes / 64) blocks.  The
// pair products and predicates are pair_g2.cuh's, shared with K7 and K6
// on G2.
#include "pair_g2.cuh"
#include "scan_rows.cuh"

namespace zk {

// 12 words of a row, 16-byte aligned, by three 16-byte loads through the
// read-only cache.  Volatile, so that the compiler never merges a second
// load of a row's coordinate with the first and keeps the words live
// between them: the madd loads each coordinate again where it multiplies.
__device__ __forceinline__ void h_load(FqE& r, const uint32_t* words) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.v[4 * k]), "=r"(r.v[4 * k + 1]),
                   "=r"(r.v[4 * k + 2]), "=r"(r.v[4 * k + 3])
                 : "l"(words + 4 * k));
}

// acc += q, the affine point of `row` (this thread's X component at
// row[0], its Y component at row[24]; (0, 0) = infinity, q_zero: this
// thread's components of q are zero): jac_madd_inl<G2Field> (curve.cuh)
// on components.  `same` reports the doubling case (acc == q, both
// finite), whose output is the formula's garbage.  q's coordinates are
// loaded where they are multiplied (from L1), so they hold no registers
// across the products before.
__device__ __forceinline__ void pair_madd(PairJac& acc, bool& same,
                                          const uint32_t* row, bool q_zero,
                                          uint32_t h, unsigned m) {
  const bool p_inf = pair_all(m, fq_is_zero(acc.Z));
  const bool q_inf = pair_all(m, q_zero);
  same = false;
  if (q_inf) return;
  if (p_inf) {
    h_load(acc.X, row);
    h_load(acc.Y, row + 24);
    h_one_or_zero(acc.Z, true, h);
    return;
  }
  FqE Z1Z1, U2, S2, H, r, I, J, V, t, u;
  Z1Z1 = pair_sqr(acc.Z, h, m);
  h_load(t, row);                            // qx
  pair_mul(U2, t, Z1Z1, h, m);
  pair_mul(t, acc.Z, Z1Z1, h, m);
  h_load(u, row + 24);                       // qy
  pair_mul(S2, u, t, h, m);
  fq_sub(H, U2, acc.X);
  fq_sub(r, S2, acc.Y);
  same = pair_all(m, fq_is_zero(H) && fq_is_zero(r));
  pair_mul(t, acc.Z, H, h, m);
  fq_add(acc.Z, t, t);                    // Z3 = 2 Z H
  t = pair_sqr(H, h, m);                     // HH
  fq_add(t, t, t);
  fq_add(I, t, t);
  pair_mul(J, H, I, h, m);
  pair_mul(V, acc.X, I, h, m);
  fq_add(r, r, r);                        // r2
  t = pair_sqr(r, h, m);
  fq_sub(t, t, J);
  fq_add(u, V, V);
  fq_sub(acc.X, t, u);                    // X3
  pair_mul(t, acc.Y, J, h, m);
  fq_add(t, t, t);
  fq_sub(u, V, acc.X);
  pair_mul(acc.Y, r, u, h, m);
  fq_sub(acc.Y, acc.Y, t);                // Y3
}

// 128 threads (64 lanes) a block, 3 blocks an SM: 12 warps, 167
// registers.
constexpr int kPairT = 128;
constexpr int kPairBlocksPerSM = 3;
constexpr int kPairLanes = kPairT / 2;

// Lane (chunk) l = b M + m covers positions l K .. l K + K - 1 of the
// (B, n) idx / seg arrays, n = M K (scan_rows.cuh); a block's kPairT
// threads hold kPairLanes lanes.
__global__ void __launch_bounds__(kPairT, kPairBlocksPerSM)
k_bucket_scan_rows_g2(const uint32_t* __restrict__ rows,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ seg, uint32_t* tx,
                      uint32_t* ty, uint32_t* tz, uint32_t* bx, uint32_t* by,
                      uint32_t* bz, int32_t* flag, int K, int64_t lanes,
                      int64_t M, int nb) {
  extern __shared__ int32_t staged[];
  const int KP = K + 1;
  int32_t* s_idx = staged;
  int32_t* s_seg = staged + kPairLanes * KP;
  const int64_t lane0 = (int64_t)blockIdx.x * kPairLanes;
  const int nl = (int)min((int64_t)kPairLanes, lanes - lane0);
  // seg null: zeros, so the loop tests no pointer
  stage_chunks(s_idx, s_seg, idx, seg, lane0, nl, K, kPairT, true);
  __syncthreads();
  const int jl = threadIdx.x >> 1;
  if (jl >= nl) return;                      // a pair is live or idle whole
  const uint32_t h = threadIdx.x & 1u;
  const unsigned m = pair_mask();
  const int64_t lane = lane0 + jl;
  const int32_t* my_idx = s_idx + jl * KP;
  const int32_t* my_seg = s_seg + jl * KP;
  const int64_t b = lane / M;
  const int32_t after = chunk_after(seg, lane, M, K, nb);
  const int64_t ncols = lanes / M * nb;
  PairJac acc;
  bool collided = false;
#pragma unroll 1
  for (int t = 0; t < K; ++t) {
    const uint32_t* row = rows + (int64_t)my_idx[t] * 48 + 12 * h;
    FqE cx, cy;
    h_load(cx, row);
    h_load(cy, row + 24);
    const bool q_zero = fq_is_zero(cx) && fq_is_zero(cy);
    if (t > 0 && my_seg[t] == my_seg[t - 1]) {
      bool same;
      pair_madd(acc, same, row, q_zero, h, m);
      collided |= same;
    } else {
      acc.X = cx;
      acc.Y = cy;
      h_one_or_zero(acc.Z, !pair_all(m, q_zero), h);
    }
    const int32_t d = run_end(my_seg, t, K, after, nb);   // nb = 0: -1
    if (d >= 0) {
      const int64_t col = b * nb + d;
      h_store(bx, col, ncols, h, acc.X);
      h_store(by, col, ncols, h, acc.Y);
      h_store(bz, col, ncols, h, acc.Z);
    }
  }
  h_store(tx, lane, lanes, h, acc.X);
  h_store(ty, lane, lanes, h, acc.Y);
  h_store(tz, lane, lanes, h, acc.Z);
  if (!h) flag[lane] = collided ? 1 : 0;
}

int launch_scan_rows_g2(const void* rows, const void* idx, const void* seg,
                        void* tx, void* ty, void* tz, void* bx, void* by,
                        void* bz, void* flag, int K, int64_t lanes,
                        int64_t M, int nb, cudaStream_t s) {
  const size_t smem = (size_t)kPairLanes * (K + 1) * sizeof(int32_t) * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k_bucket_scan_rows_g2, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_bucket_scan_rows_g2<<<blocks_for(lanes, kPairLanes), kPairT, smem, s>>>(
      (const uint32_t*)rows, (const int32_t*)idx, (const int32_t*)seg,
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, (int32_t*)flag, K, lanes, M, nb);
  return (int)cudaGetLastError();
}

// The pair products alone, for tests: prod = a b and sq = a^2 of n Fq2
// elements in Montgomery form, coordinates (2, 12, n), a thread pair an
// element, as the kernel above forms them.
__global__ void k_fq2_pair_products(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    uint32_t* prod, uint32_t* sq, int64_t n) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  if (e >= n) return;                        // a pair is live or idle whole
  const uint32_t h = threadIdx.x & 1u;
  const unsigned m = pair_mask();
  FqE x, y, r;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    x.v[j] = a[(12 * h + j) * n + e];
    y.v[j] = b[(12 * h + j) * n + e];
  }
  pair_mul(r, x, y, h, m);
  h_store(prod, e, n, h, r);
  r = pair_sqr(x, h, m);
  h_store(sq, e, n, h, r);
}

}  // namespace zk

// a, b, prod, sq: (2, 12, n) Fq2 coordinates, n >= 1.
extern "C" int zk_fq2_pair_products(const void* a, const void* b, void* prod,
                                    void* sq, int64_t n, void* stream) {
  zk::k_fq2_pair_products<<<zk::blocks_for(2 * n, zk::kPairT), zk::kPairT, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)prod, (uint32_t*)sq,
      n);
  return (int)cudaGetLastError();
}
