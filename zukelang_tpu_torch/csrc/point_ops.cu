// K2: batched Jacobian point add and double over G1 and G2.
// Replaces point_add_pallas / point_double_pallas
// (zukelang_tpu/ops/pallas_kernels.py:346, :359) and the G2 forms
// point_add_pallas_g2 / point_double_pallas_g2 (:529, :541).
// K3: batched mixed add, Jacobian p + affine q with (0, 0) = infinity.
// Replaces point_madd_pallas / point_madd_pallas_g2 (:663, :680; kernels
// _point_madd_kernel / _point_madd_kernel2 :594, :615): madd-2007-bl
// through jac_madd, the output and the per-lane doubling flag as the
// Pallas kernel leaves them (a flagged lane holds the formula's garbage;
// ops.curve.point_madd fixes it with K2's doubling).
// One thread per element; coordinates are limb-major (rows, n) columns.
#include "curve.cuh"

namespace zk {

template <class G>
__global__ void __launch_bounds__(128)
k_point_add(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
            const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
            uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p, q, r;
  jac_load<G>(p, x1, y1, z1, i, n);
  jac_load<G>(q, x2, y2, z2, i, n);
  jac_add<G>(r, p, q);
  jac_store<G>(ox, oy, oz, i, n, r);
}

template <class G>
__global__ void __launch_bounds__(128)
k_point_double(const uint32_t* x, const uint32_t* y, const uint32_t* z,
               uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p, r;
  jac_load<G>(p, x, y, z, i, n);
  jac_double<G>(r, p);
  jac_store<G>(ox, oy, oz, i, n, r);
}

template <class G>
__global__ void __launch_bounds__(128)
k_point_madd(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
             const uint32_t* x2, const uint32_t* y2, uint32_t* ox,
             uint32_t* oy, uint32_t* oz, int32_t* flag, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p, r;
  typename G::E qx, qy;
  jac_load<G>(p, x1, y1, z1, i, n);
  G::load(qx, x2 + i, n);
  G::load(qy, y2 + i, n);
  bool same;
  jac_madd<G>(r, same, p, qx, qy);
  jac_store<G>(ox, oy, oz, i, n, r);
  flag[i] = same ? 1 : 0;
}

}  // namespace zk

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

extern "C" int zk_point_add(int g2, const void* x1, const void* y1,
                            const void* z1, const void* x2, const void* y2,
                            const void* z2, void* ox, void* oy, void* oz,
                            int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_point_add<zk::G2Field><<<blocks, 128, 0, s>>>(
        U32C(x1), U32C(y1), U32C(z1), U32C(x2), U32C(y2), U32C(z2), U32(ox),
        U32(oy), U32(oz), n);
  else
    zk::k_point_add<zk::G1Field><<<blocks, 128, 0, s>>>(
        U32C(x1), U32C(y1), U32C(z1), U32C(x2), U32C(y2), U32C(z2), U32(ox),
        U32(oy), U32(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int zk_point_double(int g2, const void* x, const void* y,
                               const void* z, void* ox, void* oy, void* oz,
                               int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_point_double<zk::G2Field><<<blocks, 128, 0, s>>>(
        U32C(x), U32C(y), U32C(z), U32(ox), U32(oy), U32(oz), n);
  else
    zk::k_point_double<zk::G1Field><<<blocks, 128, 0, s>>>(
        U32C(x), U32C(y), U32C(z), U32(ox), U32(oy), U32(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int zk_point_madd(int g2, const void* x1, const void* y1,
                             const void* z1, const void* x2, const void* y2,
                             void* ox, void* oy, void* oz, void* flag,
                             int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_point_madd<zk::G2Field><<<blocks, 128, 0, s>>>(
        U32C(x1), U32C(y1), U32C(z1), U32C(x2), U32C(y2), U32(ox), U32(oy),
        U32(oz), (int32_t*)flag, n);
  else
    zk::k_point_madd<zk::G1Field><<<blocks, 128, 0, s>>>(
        U32C(x1), U32C(y1), U32C(z1), U32C(x2), U32C(y2), U32(ox), U32(oy),
        U32(oz), (int32_t*)flag, n);
  return (int)cudaGetLastError();
}
