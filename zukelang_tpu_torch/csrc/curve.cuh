// Jacobian group law over G1 (Fq) and G2 (Fq2), templated on the
// coordinate field (G1Field / G2Field in field.cuh).
//
// The formulas are those of zukelang_tpu/ops/pallas_kernels.py:
//   jac_double  _double_body        :237  (dbl-2009-l, a = 0)
//   jac_add     _point_add_kernel   :272  (add-2007-bl, every special case)
//   jac_madd    _madd_core          :567  (madd-2007-bl + degenerate flag)
// and of the plain versions in ops/kernels.py, so results agree bit for bit.
// Each function writes its output last, so it may alias an input.
#pragma once

#include "field.cuh"

namespace zk {

template <class G>
struct Jac {
  typename G::E X, Y, Z;
};

template <class G>
__device__ __forceinline__ void jac_load(Jac<G>& p, const uint32_t* x,
                                         const uint32_t* y, const uint32_t* z,
                                         int64_t col, int64_t stride) {
  G::load(p.X, x + col, stride);
  G::load(p.Y, y + col, stride);
  G::load(p.Z, z + col, stride);
}

template <class G>
__device__ __forceinline__ void jac_store(uint32_t* x, uint32_t* y,
                                          uint32_t* z, int64_t col,
                                          int64_t stride, const Jac<G>& p) {
  G::store(x + col, stride, p.X);
  G::store(y + col, stride, p.Y);
  G::store(z + col, stride, p.Z);
}

// Per group of g lanes, lane i gets lane i - d's point (its own where
// i < d).  Every lane of the warp must call it; out may alias p.
template <class G>
__device__ __forceinline__ void jac_shfl_up(Jac<G>& out, const Jac<G>& p,
                                            int d, int g) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&p);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Jac<G>) / 4); ++k)
    dst[k] = __shfl_up_sync(0xffffffffu, src[k], d, g);
}

template <class G>
__device__ __noinline__ void jac_double(Jac<G>& out, const Jac<G>& p) {
  using E = typename G::E;
  E A, B, C, t, D, E3, Fv, X3, Y3, Z3, c8, tmp;
  G::mul(A, p.X, p.X);
  G::mul(B, p.Y, p.Y);
  G::mul(C, B, B);
  G::add(t, p.X, B);
  G::mul(t, t, t);
  G::sub(D, t, A);
  G::sub(D, D, C);
  G::add(D, D, D);
  G::add(E3, A, A);
  G::add(E3, E3, A);
  G::mul(Fv, E3, E3);
  G::add(tmp, D, D);
  G::sub(X3, Fv, tmp);
  G::add(c8, C, C);
  G::add(c8, c8, c8);
  G::add(c8, c8, c8);
  G::sub(tmp, D, X3);
  G::mul(Y3, E3, tmp);
  G::sub(Y3, Y3, c8);
  G::mul(tmp, p.Y, p.Z);
  G::add(Z3, tmp, tmp);
  out.X = X3;
  out.Y = Y3;
  out.Z = Z3;
}

template <class G>
__device__ __noinline__ void jac_add(Jac<G>& out, const Jac<G>& p,
                                     const Jac<G>& q) {
  using E = typename G::E;
  const bool p_inf = G::is_zero(p.Z);
  const bool q_inf = G::is_zero(q.Z);
  if (q_inf) {
    out = p;
    return;
  }
  if (p_inf) {
    out = q;
    return;
  }
  E Z1Z1, Z2Z2, U1, U2, S1, S2, H, r, H2, I, J, r2, V, X3, Y3, Z3, t, u;
  G::mul(Z1Z1, p.Z, p.Z);
  G::mul(Z2Z2, q.Z, q.Z);
  G::mul(U1, p.X, Z2Z2);
  G::mul(U2, q.X, Z1Z1);
  G::mul(t, p.Y, q.Z);
  G::mul(S1, t, Z2Z2);
  G::mul(t, q.Y, p.Z);
  G::mul(S2, t, Z1Z1);
  G::sub(H, U2, U1);
  G::sub(r, S2, S1);
  if (G::is_zero(H) && G::is_zero(r)) {  // P == Q: the doubling
    jac_double<G>(out, p);
    return;
  }
  G::add(H2, H, H);
  G::mul(I, H2, H2);
  G::mul(J, H, I);
  G::add(r2, r, r);
  G::mul(V, U1, I);
  G::mul(t, r2, r2);
  G::sub(t, t, J);
  G::add(u, V, V);
  G::sub(X3, t, u);
  G::mul(t, S1, J);
  G::add(t, t, t);
  G::sub(u, V, X3);
  G::mul(Y3, r2, u);
  G::sub(Y3, Y3, t);
  G::add(t, p.Z, q.Z);
  G::mul(t, t, t);
  G::sub(t, t, Z1Z1);
  G::sub(t, t, Z2Z2);
  G::mul(Z3, t, H);
  out.X = X3;
  out.Y = Y3;
  out.Z = Z3;
}

// p Jacobian + affine (qx, qy) with (0, 0) = infinity.  `same` reports the
// doubling-degenerate lane (p == q, both finite), whose output is the
// formula's garbage, exactly as the Pallas kernel leaves it.  Inlined
// where the caller runs it in a loop with the accumulator in registers
// (K5); `jac_madd` is the out-of-line copy.
template <class G>
__device__ __forceinline__ void jac_madd_inl(Jac<G>& out, bool& same,
                                             const Jac<G>& p,
                                             const typename G::E& qx,
                                             const typename G::E& qy) {
  using E = typename G::E;
  const bool p_inf = G::is_zero(p.Z);
  const bool q_inf = G::is_zero(qx) && G::is_zero(qy);
  same = false;
  if (q_inf) {
    out = p;
    return;
  }
  if (p_inf) {
    out.X = qx;
    out.Y = qy;
    G::set_one(out.Z);
    return;
  }
  E Z1Z1, U2, S2, H, r, HH, I, J, r2, V, X3, Y3, Z3, t, u;
  G::mul(Z1Z1, p.Z, p.Z);
  G::mul(U2, qx, Z1Z1);
  G::mul(t, p.Z, Z1Z1);
  G::mul(S2, qy, t);
  G::sub(H, U2, p.X);
  G::sub(r, S2, p.Y);
  same = G::is_zero(H) && G::is_zero(r);
  G::mul(HH, H, H);
  G::add(t, HH, HH);
  G::add(I, t, t);
  G::mul(J, H, I);
  G::add(r2, r, r);
  G::mul(V, p.X, I);
  G::mul(t, r2, r2);
  G::sub(t, t, J);
  G::add(u, V, V);
  G::sub(X3, t, u);
  G::mul(t, p.Y, J);
  G::add(t, t, t);
  G::sub(u, V, X3);
  G::mul(Y3, r2, u);
  G::sub(Y3, Y3, t);
  G::add(t, p.Z, H);
  G::mul(t, t, t);
  G::sub(t, t, Z1Z1);
  G::sub(Z3, t, HH);
  out.X = X3;
  out.Y = Y3;
  out.Z = Z3;
}

template <class G>
__device__ __noinline__ void jac_madd(Jac<G>& out, bool& same, const Jac<G>& p,
                                      const typename G::E& qx,
                                      const typename G::E& qy) {
  jac_madd_inl<G>(out, same, p, qx, qy);
}

}  // namespace zk
