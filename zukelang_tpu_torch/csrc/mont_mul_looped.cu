// K1's product with the outer limb loop kept rolled: a * b * R^-1 mod p,
// canonical, for Fr and Fq.  Replaces _mont_mul_kernel_looped
// (scripts/probe_looped_kernel.py:29, call _looped_call :75), a probe of
// compile time against body size: on the TPU the loop cut the Mosaic body
// about 24-fold.  Here the loop over b's limbs is `#pragma unroll 1`, the
// two inner loops over a's limbs and p's limbs are unrolled, so the
// accumulator t stays in registers (its indices are constants inside the
// inner loops) and b's limb k is read from device memory at step k, as
// the Pallas kernel reads a_ref[pl.ds(i, 1)].  The arithmetic is
// fp_mul's (field.cuh), so the outputs equal K1's bit for bit.  Kept in
// its own source so that the build reports its nvcc time and ptxas
// registers apart from mont_mul.cu.  Bound: the same integer products as
// K1 plus the loop's branch and address arithmetic.
#include "field.cuh"

namespace zk {

template <class F>
__global__ void __launch_bounds__(128)
k_mont_mul_looped(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::NL;
  uint32_t x[N], t[N + 2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = a[j * n + i];
    t[j] = 0;
  }
  t[N] = t[N + 1] = 0;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const uint32_t bk = b[k * n + i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c = (uint64_t)x[j] * bk + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::NPRIME;
    c = (uint64_t)m * F::p(0) + t[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c = (uint64_t)m * F::p(j) + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
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

}  // namespace zk

// field: 0 = Fr, 1 = Fq.  a, b, out: (nl, n) limb-major.
extern "C" int zk_mont_mul_looped(int field, const void* a, const void* b,
                                  void* out, int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    zk::k_mont_mul_looped<zk::Fr><<<blocks, 128, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else
    zk::k_mont_mul_looped<zk::Fq><<<blocks, 128, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
