// K2's chained doubling over G1 and G2.  Replaces point_double_pallas
// (zukelang_tpu/ops/pallas_kernels.py:359; body _double_body :237) and
// point_double_pallas_g2 (:541; _double_body2 :412).  K2's add is in
// point_add.cu, K3 in point_madd.cu, the formulas on a group of lanes in
// point_lanes.cuh.
//
// The doubling (k_point_double_n) doubles point i counts[i] times in one
// launch.  On its path (the window combine: 80 / 20 points, up to 247
// doublings of the top window) it is bound by latency, not operations:
// the chain of doublings is sequential, and each dbl-2009-l doubling is
// only three levels of dependent coordinate products,
//   1. A = X^2, B = Y^2, Y Z     2. C = B^2, (X + B)^2, F = (3A)^2
//   3. (3A) (D - X3).
// So a group of L lanes works on one point and the independent Fq
// products of a level run on different lanes: G1 has 3, 3 and 1 products,
// G2 (squares as (a0 + a1)(a0 - a1), 2 a0 a1; products by Karatsuba) 7, 6
// and 3.  At L = 3 (G1) or 7 (G2) a doubling is a chain of three Fq
// products (against 7 and 21 for one thread), with the results passed
// between the group's lanes by __shfl_sync.  Every lane keeps the whole
// point in registers across the chain and repeats the cheap additions, and
// the products are inlined (no call through the stack).  Field results
// are canonical, so any split gives the same words as the plain version.
// A warp runs to its largest count; a point whose count is reached keeps
// its value, as in the masked loop of the JAX package's _combine_windows.
#include "point_lanes.cuh"

namespace zk {

constexpr int kDblThreads = 64;

// L lanes per point, 32 / L points per warp (the lanes past the last
// group run along for the shuffles and store nothing).
template <class G, int L>
__global__ void __launch_bounds__(kDblThreads)
k_point_double_n(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                 const int32_t* counts, int count, uint32_t* ox, uint32_t* oy,
                 uint32_t* oz, int64_t n) {
  constexpr int P = 32 / L;
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int sub = lane - g * L;
  const int base = g * L;
  const int64_t i =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * P + g;
  const bool live = g < P && i < n;
  Jac<G> p;
  int cnt = 0;
  if (live) {
    jac_load<G>(p, x, y, z, i, n);
    cnt = counts ? counts[i] : count;
  } else {
    G::set_zero(p.X);
    G::set_zero(p.Y);
    G::set_zero(p.Z);
  }
  const int steps = __reduce_max_sync(kFull, cnt);
  for (int s = 0; s < steps; ++s) {
    Jac<G> r;
    dbl_step<L>(r, p, sub, base);
    if (s < cnt) p = r;
  }
  if (live && sub == 0) jac_store<G>(ox, oy, oz, i, n, p);
}

template <class G, int L>
int launch_double_n(const void* x, const void* y, const void* z,
                    const void* counts, int count, void* ox, void* oy,
                    void* oz, int64_t n, cudaStream_t s) {
  constexpr int P = 32 / L;
  const unsigned blocks = blocks_for((n + P - 1) / P * 32, kDblThreads);
  k_point_double_n<G, L><<<blocks, kDblThreads, 0, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const int32_t*)counts, count, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

}  // namespace zk

// Point i doubled counts[i] times (count for every point when counts is
// null; a count of 0 or less keeps the point), 3 lanes per G1 point (10
// points a warp) or 7 per G2 point (4 points a warp).
extern "C" int zk_point_double_n(int g2, const void* x, const void* y,
                                 const void* z, const void* counts, int count,
                                 void* ox, void* oy, void* oz, int64_t n,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_double_n<zk::G2Field, 7>(x, y, z, counts, count, ox, oy,
                                               oz, n, s);
  return zk::launch_double_n<zk::G1Field, 3>(x, y, z, counts, count, ox, oy,
                                             oz, n, s);
}
