// K1: batched Montgomery product a * b * R^-1 mod p, for Fr and Fq.
// Replaces mont_mul_pallas (zukelang_tpu/ops/pallas_kernels.py:201, kernel
// _mont_mul_kernel :132).  One thread per element; limb j of element i is
// at [j * n + i], so each limb load is coalesced across the warp.
#include "field.cuh"

namespace zk {

template <class F>
__global__ void __launch_bounds__(128)
k_mont_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::NL], y[F::NL], r[F::NL];
#pragma unroll
  for (int j = 0; j < F::NL; ++j) {
    x[j] = a[j * n + i];
    y[j] = b[j * n + i];
  }
  fp_mul<F>(r, x, y);
#pragma unroll
  for (int j = 0; j < F::NL; ++j) out[j * n + i] = r[j];
}

// The latency of one dependent Fq product: one thread runs x <- x * b
// `reps` times (profile_kernels' chain bounds).  Not a path kernel.  x is
// indexed by the thread, as the point kernels' operands are: on an
// address the compiler can prove uniform it moves the chain to the
// uniform datapath, whose products are slower (an H100: 2.34 against
// 1.32 us a product).
__global__ void k_fq_mul_chain(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, int reps) {
  const unsigned t = threadIdx.x;
  uint32_t x[Fq::NL], y[Fq::NL];
#pragma unroll
  for (int j = 0; j < Fq::NL; ++j) {
    x[j] = a[j + t];
    y[j] = b[j];
  }
#pragma unroll 1
  for (int i = 0; i < reps; ++i) fp_mul<Fq>(x, x, y);
#pragma unroll
  for (int j = 0; j < Fq::NL; ++j) out[j + t] = x[j];
}

}  // namespace zk

// field: 0 = Fr, 1 = Fq.  a, b, out: (nl, n) limb-major.
extern "C" int zk_mont_mul(int field, const void* a, const void* b, void* out,
                           int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    zk::k_mont_mul<zk::Fr><<<blocks, 128, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else
    zk::k_mont_mul<zk::Fq><<<blocks, 128, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// a, b, out: (12, 1) Fq; out = a * b^reps * R^-reps on one thread.
extern "C" int zk_fq_mul_chain(const void* a, const void* b, void* out,
                               int reps, void* stream) {
  zk::k_fq_mul_chain<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, reps);
  return (int)cudaGetLastError();
}
