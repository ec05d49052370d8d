// K2: batched Jacobian point add, and the chained doubling, over G1 and G2.
// Replaces point_add_pallas / point_double_pallas
// (zukelang_tpu/ops/pallas_kernels.py:346, :359; bodies _point_add_kernel
// :272, _double_body :237) and the G2 forms point_add_pallas_g2 /
// point_double_pallas_g2 (:529, :541; _double_body2 :412).
// K3: batched mixed add, Jacobian p + affine q with (0, 0) = infinity.
// Replaces point_madd_pallas / point_madd_pallas_g2 (:663, :680; kernels
// _point_madd_kernel / _point_madd_kernel2 :594, :615): madd-2007-bl
// through jac_madd, the output and the per-lane doubling flag as the
// Pallas kernel leaves them (a flagged lane holds the formula's garbage;
// ops.curve.point_madd fixes it with K2's doubling).
// The add and K3 run one thread per element; coordinates are limb-major
// (rows, n) columns.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDblThreads = 64;

template <int N>
__device__ __forceinline__ void copy_limbs(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = a[j];
}

// One level of NR independent Fq products a[r] * b[r], spread over the L
// lanes of a group: lane `sub` computes roles sub, sub + L, ... (a lane
// past the last role repeats one, and its result is dropped); then every
// lane of the group gathers all NR results from lane base + r % L.
template <int L, int NR>
__device__ __forceinline__ void spread_products(
    uint32_t (&res)[NR][12], const uint32_t* const (&a)[NR],
    const uint32_t* const (&b)[NR], int sub, int base) {
  constexpr int S = (NR + L - 1) / L;
  uint32_t loc[S][12];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int r = k * L + sub;
    uint32_t x[12], y[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      uint32_t u = a[k * L][j], v = b[k * L][j];
#pragma unroll
      for (int i = k * L + 1; i < (k + 1) * L && i < NR; ++i) {
        u = r == i ? a[i][j] : u;
        v = r == i ? b[i][j] : v;
      }
      x[j] = u;
      y[j] = v;
    }
    fp_mul<Fq>(loc[k], x, y);
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int j = 0; j < 12; ++j)
      res[r][j] = __shfl_sync(kFull, loc[r / L][j], base + r % L);
  }
}

// dbl-2009-l (a = 0) on G1, the formula of _double_body (pallas :237).
template <int L>
__device__ __forceinline__ void dbl_step(Jac<G1Field>& o, const Jac<G1Field>& p,
                                         int sub, int base) {
  const uint32_t *X = p.X.v, *Y = p.Y.v, *Z = p.Z.v;
  uint32_t l1[3][12];                              // A, B, Y Z
  {
    const uint32_t* const a[3] = {X, Y, Y};
    const uint32_t* const b[3] = {X, Y, Z};
    spread_products<L, 3>(l1, a, b, sub, base);
  }
  uint32_t E[12], XB[12];
  fp_add<Fq>(E, l1[0], l1[0]);
  fp_add<Fq>(E, E, l1[0]);
  fp_add<Fq>(XB, X, l1[1]);
  uint32_t l2[3][12];                              // F, C, (X + B)^2
  {
    const uint32_t* const a[3] = {E, l1[1], XB};
    spread_products<L, 3>(l2, a, a, sub, base);
  }
  uint32_t D[12], t[12], c8[12];
  fp_sub<Fq>(D, l2[2], l1[0]);
  fp_sub<Fq>(D, D, l2[1]);
  fp_add<Fq>(D, D, D);
  fp_add<Fq>(t, D, D);
  fp_sub<Fq>(o.X.v, l2[0], t);
  fp_add<Fq>(c8, l2[1], l2[1]);
  fp_add<Fq>(c8, c8, c8);
  fp_add<Fq>(c8, c8, c8);
  fp_sub<Fq>(t, D, o.X.v);
  uint32_t l3[1][12];                              // E (D - X3)
  {
    const uint32_t* const a[1] = {E};
    const uint32_t* const b[1] = {t};
    spread_products<L, 1>(l3, a, b, sub, base);
  }
  fp_sub<Fq>(o.Y.v, l3[0], c8);
  fp_add<Fq>(o.Z.v, l1[2], l1[2]);
}

__device__ __forceinline__ void fq2_add(Fq2E& r, const Fq2E& a, const Fq2E& b) {
  fp_add<Fq>(r.c0, a.c0, b.c0);
  fp_add<Fq>(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fq2_sub(Fq2E& r, const Fq2E& a, const Fq2E& b) {
  fp_sub<Fq>(r.c0, a.c0, b.c0);
  fp_sub<Fq>(r.c1, a.c1, b.c1);
}

// The square u^2 of an Fq2 element from the products (u0 + u1)(u0 - u1)
// and u0 u1: (c0, c1) = (s, 2 m).
__device__ __forceinline__ void fq2_from_square(Fq2E& r, const uint32_t* s,
                                                const uint32_t* m) {
  copy_limbs<12>(r.c0, s);
  fp_add<Fq>(r.c1, m, m);
}

// dbl-2009-l on G2, the formula of _double_body2 (pallas :412).
template <int L>
__device__ __forceinline__ void dbl_step(Jac<G2Field>& o, const Jac<G2Field>& p,
                                         int sub, int base) {
  const Fq2E &X = p.X, &Y = p.Y, &Z = p.Z;
  uint32_t xs[12], xd[12], ys[12], yd[12], zs[12];
  fp_add<Fq>(xs, X.c0, X.c1);
  fp_sub<Fq>(xd, X.c0, X.c1);
  fp_add<Fq>(ys, Y.c0, Y.c1);
  fp_sub<Fq>(yd, Y.c0, Y.c1);
  fp_add<Fq>(zs, Z.c0, Z.c1);
  uint32_t l1[7][12];            // A = X^2, B = Y^2 (two each), Y Z (three)
  {
    const uint32_t* const a[7] = {xs, X.c0, ys, Y.c0, Y.c0, Y.c1, ys};
    const uint32_t* const b[7] = {xd, X.c1, yd, Y.c1, Z.c0, Z.c1, zs};
    spread_products<L, 7>(l1, a, b, sub, base);
  }
  Fq2E A, B, YZ, E, XB;
  fq2_from_square(A, l1[0], l1[1]);
  fq2_from_square(B, l1[2], l1[3]);
  fp_sub<Fq>(YZ.c0, l1[4], l1[5]);
  fp_sub<Fq>(YZ.c1, l1[6], l1[4]);
  fp_sub<Fq>(YZ.c1, YZ.c1, l1[5]);
  fq2_add(E, A, A);
  fq2_add(E, E, A);
  fq2_add(XB, X, B);
  uint32_t bs[12], bd[12], es[12], ed[12], ts[12], td[12];
  fp_add<Fq>(bs, B.c0, B.c1);
  fp_sub<Fq>(bd, B.c0, B.c1);
  fp_add<Fq>(es, E.c0, E.c1);
  fp_sub<Fq>(ed, E.c0, E.c1);
  fp_add<Fq>(ts, XB.c0, XB.c1);
  fp_sub<Fq>(td, XB.c0, XB.c1);
  uint32_t l2[6][12];            // C = B^2, F = E^2, T = (X + B)^2
  {
    const uint32_t* const a[6] = {bs, B.c0, es, E.c0, ts, XB.c0};
    const uint32_t* const b[6] = {bd, B.c1, ed, E.c1, td, XB.c1};
    spread_products<L, 6>(l2, a, b, sub, base);
  }
  Fq2E C, Fv, T, D, t, c8;
  fq2_from_square(C, l2[0], l2[1]);
  fq2_from_square(Fv, l2[2], l2[3]);
  fq2_from_square(T, l2[4], l2[5]);
  fq2_sub(D, T, A);
  fq2_sub(D, D, C);
  fq2_add(D, D, D);
  fq2_add(t, D, D);
  fq2_sub(o.X, Fv, t);
  fq2_add(c8, C, C);
  fq2_add(c8, c8, c8);
  fq2_add(c8, c8, c8);
  fq2_sub(t, D, o.X);
  uint32_t dxs[12];
  fp_add<Fq>(dxs, t.c0, t.c1);
  uint32_t l3[3][12];            // E (D - X3) by Karatsuba
  {
    const uint32_t* const a[3] = {E.c0, E.c1, es};
    const uint32_t* const b[3] = {t.c0, t.c1, dxs};
    spread_products<L, 3>(l3, a, b, sub, base);
  }
  fp_sub<Fq>(t.c0, l3[0], l3[1]);
  fp_sub<Fq>(t.c1, l3[2], l3[0]);
  fp_sub<Fq>(t.c1, t.c1, l3[1]);
  fq2_sub(o.Y, t, c8);
  fq2_add(o.Z, YZ, YZ);
}

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
