// The card's rate of limb products, measured: the peak behind
// msm_roofline.  A limb product (32 x 32 -> 64 bits, the unit of a
// Montgomery product over 32-bit limbs) needs two integer multiply-adds,
// the low and the high word (mad.lo.u32 and mad.hi.u32).  Each thread
// runs CHAINS independent chains, each step a low then a high
// multiply-add, so the integer multiply pipe never waits on a result;
// the chains' ends are written out, so nothing is left out.
#include <cstdint>
#include <cuda_runtime.h>

#define CHAINS 8
#define UNROLL 8

__global__ void limb_products(uint32_t* out, uint32_t y, uint32_t z,
                              int iters) {
  uint32_t x[CHAINS];
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) x[i] = t * 2654435761u + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) {
        asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(y), "r"(z));
        asm("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(y), "r"(z));
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc ^= x[i];
  out[t] = acc;
}

// Launches blocks x threads threads of iters x UNROLL x CHAINS limb
// products each on `stream`; -> the CUDA error code.
extern "C" int zkbench_limb_products(void* out, int blocks, int threads,
                                     int iters, uint32_t y, uint32_t z,
                                     void* stream) {
  limb_products<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, y, z, iters);
  return (int)cudaGetLastError();
}

extern "C" int zkbench_limb_products_per_thread_step() {
  return UNROLL * CHAINS;
}
