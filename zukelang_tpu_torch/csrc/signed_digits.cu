// K9: the signed window digits of a batch of MSM scalars, in the MSM's
// block layout.  Replaces no Pallas kernel: the JAX package computes these
// digits as XLA code (zukelang_tpu/ops/msm.py:45-86, _scalars_to_windows
// and _scalars_to_signed_windows, after from_mont at
// zukelang_tpu/ops/field_jax.py:375), which XLA fuses into one pass.  Run
// eagerly, the same chain is some 170 small PyTorch ops a batch, each a
// launch the host pays about 20 us for while the card waits.
//
// Bound: bytes.  A scalar is read once (32 B) and its W = ceil(256 / c)
// digits written once (4 W B): at 2^16 (B = 4, c = 13) 8 MB read and 21 MB
// written, about 9 us at 3.35 TB/s.  The Montgomery reduction (one Fr
// product by 1, 136 limb products) is far below the card's integer rate.
//
// Design: one thread a (MSM j, column i), neighbouring threads on
// neighbouring columns, so every limb load and every digit store is
// coalesced.  The thread takes its scalar out of Montgomery form in
// registers (fp_mul<Fr> by 1, canonical as K1's result), then walks the
// 256 bits low to high through a 64-bit bit buffer, one limb at a time,
// so that the limbs stay in registers for any c.  Each raw window v gets
// the signed carry of _scalars_to_signed_windows: v + carry above
// 2^(c-1) becomes v + carry - 2^c with carry 1.  The top window is
// partial where c does not divide 256 and reads zeros above bit 255; the
// carry out of it is dropped (scalars are < 2^255).  Digit w of MSM j
// goes to row j W + w, column i, of the (B W, n) output.
#include "field.cuh"

namespace zk {

__global__ void __launch_bounds__(128)
k_signed_digits(const uint32_t* __restrict__ scalars, int32_t* __restrict__ out,
                int64_t n, int c, int W, int mont) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t j = blockIdx.y;
  const uint32_t* col = scalars + j * Fr::NL * n + i;
  uint32_t x[Fr::NL];
#pragma unroll
  for (int l = 0; l < Fr::NL; ++l) x[l] = col[l * n];
  if (mont) {
    const uint32_t one[Fr::NL] = {1u};
    fp_mul<Fr>(x, x, one);
  }
  int32_t* dst = out + j * W * n + i;
  const uint32_t mask = (1u << c) - 1u, half = 1u << (c - 1);
  uint32_t carry = 0;
  uint64_t buf = 0;  // the bits not yet cut into windows, lowest first
  int nbits = 0;     // how many; below c between limbs
  auto emit = [&](uint32_t raw) {
    const uint32_t v = raw + carry;
    carry = v > half;
    *dst = carry ? (int32_t)v - (int32_t)(1u << c) : (int32_t)v;
    dst += n;
  };
#pragma unroll
  for (int l = 0; l < Fr::NL; ++l) {
    buf |= (uint64_t)x[l] << nbits;
    nbits += 32;
    for (; nbits >= c; nbits -= c, buf >>= c) emit((uint32_t)buf & mask);
  }
  if (nbits > 0) emit((uint32_t)buf & mask);
}

}  // namespace zk

// scalars: (B, 8, n) limb-major Fr, Montgomery form where mont != 0;
// out: (B * W, n) int32 signed digits, W = ceil(256 / c), 4 <= c <= 16.
extern "C" int zk_signed_digits(const void* scalars, void* out, int64_t n,
                                int B, int c, int W, int mont, void* stream) {
  const dim3 grid(zk::blocks_for(n, 128), (unsigned)B);
  zk::k_signed_digits<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (int32_t*)out, n, c, W, mont);
  return (int)cudaGetLastError();
}
