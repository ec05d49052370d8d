// K1's product with the outer limb loop kept rolled: a * b * R^-1 mod p,
// canonical, for Fr and Fq.  Replaces _mont_mul_kernel_looped
// (scripts/probe_looped_kernel.py:29, call _looped_call :75), a probe of
// compile time against body size: on the TPU the loop cut the Mosaic body
// about 24-fold.  The loop over b's limbs stays `#pragma unroll 1`, so
// the body is one CIOS step (its SASS count, against K1's unrolled
// product: `build.sass_counts`).
// Bound: at 2^20 Fq the bytes (three (12, n) arrays, 0.045 ms on an
// H100) and, close behind, the instruction throughput of the limb
// products (576 integer multiply-adds a product, two a 32 x 32 -> 64
// limb product); so the kernel has to stream and compute well at once.
// The first form lost on both counts: it loaded b's limb k from device
// memory at step k, behind the previous step's arithmetic (nothing
// prefetches across a rolled loop), and did each limb product in 64-bit
// C arithmetic.  Here:
//   * a's and b's limbs are loaded before the loop as coalesced rows of
//     the (nl, n) layout, so no step waits on device memory;
//   * each row of a CIOS step is one PTX carry chain (mad.lo.cc /
//     madc.hi.cc / addc: t += a b_k, then t = (t + m p) / 2^32 written
//     one word down in place, so t needs no moves; b's limbs move down
//     one register a step, as the loop counter cannot index registers);
//   * one element a thread, 128 threads a block: a sweep of 1, 2 or 4
//     elements a thread by 64-512 threads a block found no shape faster
//     than this one beyond noise (PERF.md), so the source builds one
//     kernel a field and its nvcc time is the one body's.
// The arithmetic is fp_mul's CIOS (field.cuh), the same m digits, so the
// outputs equal K1's bit for bit.  Kept in its own source so that the
// build reports its nvcc time and ptxas registers apart from mont_mul.cu.
// The carry chains (field.cuh's cios_mac / cios_redc): ptxas lowers each
// of their limb products to four instructions (IMAD, IMAD.HI, two
// IADD3.X), fp_mul's C form to about 3.5 (IMAD.WIDE.U32 and its adds), so
// fp_mul keeps the latter.
#include "field.cuh"

namespace zk {

// One CIOS step on t (N + 2 words): t += a * bk; then, with m = t[0] *
// NPRIME, t = (t + m p) / 2^32 (N + 1 words, t[N + 1] dead).  p's limbs
// come in registers, loaded once before the loop.
template <class F>
__device__ __forceinline__ void cios_step(uint32_t (&t)[F::NL + 2],
                                          const uint32_t (&a)[F::NL],
                                          uint32_t bk,
                                          const uint32_t (&p)[F::NL]) {
  t[F::NL + 1] = 0;                      // takes the first chain's carry
  cios_mac<F>(t, a, bk);
  cios_redc<F>(t, p);
}

// Thread x of block b takes element b T + x, its limbs read and written
// as rows of the (nl, n) layout (coalesced across the warp).
constexpr int LOOPED_T = 128;

template <class F>
__global__ void __launch_bounds__(LOOPED_T)
k_mont_mul_looped(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int64_t n) {
  constexpr int N = F::NL;
  const int64_t i = (int64_t)blockIdx.x * LOOPED_T + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], t[N + 2], p[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    p[j] = F::p(j);
    x[j] = a[j * n + i];
    y[j] = b[j * n + i];
  }
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    cios_step<F>(t, x, y[0], p);
#pragma unroll
    for (int j = 0; j + 1 < N; ++j) y[j] = y[j + 1];
  }
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = t[N] >= borrow;
#pragma unroll
  for (int j = 0; j < N; ++j) out[j * n + i] = ge ? d[j] : t[j];
}

template <class F>
int launch_looped(const void* a, const void* b, void* out, int64_t n,
                  cudaStream_t s) {
  k_mont_mul_looped<F><<<blocks_for(n, LOOPED_T), LOOPED_T, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace zk

// field: 0 = Fr, 1 = Fq.  a, b, out: (nl, n) limb-major.
extern "C" int zk_mont_mul_looped(int field, const void* a, const void* b,
                                  void* out, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) return zk::launch_looped<zk::Fr>(a, b, out, n, s);
  return zk::launch_looped<zk::Fq>(a, b, out, n, s);
}
