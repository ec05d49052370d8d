// The point formulas spread over a group of L lanes a point, for the
// kernels whose launches are too narrow to fill the card at one thread a
// point: K2's chained doubling (point_ops.cu), K2's add in its three
// launch forms (point_add.cu) and K3's chain of mixed adds
// (point_madd.cu).
//
// A formula's coordinate products fall into a few levels of independent
// Fq products (a G2 product is three Fq products by Karatsuba, a square
// two: (a0 + a1)(a0 - a1) and a0 a1).  The L lanes of a group split each
// level's products between them (`spread_products`) and pass the results
// round by __shfl_sync, so a point's chain is one Fq product a level at
// a wide enough group.  Every lane keeps both operands in registers and
// repeats the cheap additions.  Field results are canonical, so any split
// gives the plain version's words.
//
//   formula                      Fq products a level           chain at L
//   dbl-2009-l   G1 / G2         3, 3, 1 / 7, 6, 3             3 (L 3 / 7)
//   add-2007-bl  G1              4, 4, 3, 3, 2                 5 (L 4)
//                G2              10, 12, 6, 9, 6               13 / 8 (L 4 / 8)
//   madd-2007-bl G1              1, 2, 3, 3, 2                 5 (L 4)
//                G2              2, 6, 7, 8, 6                 5 (L 8)
//
// The add at one thread a point (L = 1) runs jac_add of curve.cuh
// instead: 16 coordinate products in a row.
//
// Shuffles need every lane of the warp: callers run the formulas on all
// 32 lanes (idle lanes on zeros) and branch only around them.  The rare
// P == Q case of the add and of the mixed add is the doubling
// (jac_double, one lane at a time, no shuffle).
#pragma once

#include "curve.cuh"

namespace zk {

constexpr unsigned kFull = 0xffffffffu;

template <int N>
__device__ __forceinline__ void copy_limbs(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = a[j];
}

// One level of NR independent Fq products a[r] * b[r], spread over the L
// lanes of a group: lane `sub` computes roles sub, sub + L, ... (a lane
// past the last role repeats one, and its result is dropped); then every
// lane of the group gathers all NR results from lane base + r % L.  Inl:
// the product inlined (G1), or the out-of-line fq_mul_call (G2, whose
// operands would not fit the registers otherwise).
template <int L, int NR, bool Inl = true>
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
    if (Inl)
      fp_mul<Fq>(loc[k], x, y);
    else
      fq_mul_call(loc[k], x, y);
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

// The product u v of two Fq2 elements from the Karatsuba products
// v0 = u0 v0, v1 = u1 v1, t = (u0 + u1)(v0 + v1): (v0 - v1, t - v0 - v1).
__device__ __forceinline__ void fq2_from_kara(Fq2E& r, const uint32_t* v0,
                                              const uint32_t* v1,
                                              const uint32_t* t) {
  uint32_t c1[12];
  fp_sub<Fq>(c1, t, v0);
  fp_sub<Fq>(r.c1, c1, v1);
  fp_sub<Fq>(r.c0, v0, v1);
}

// u0 + u1 and u0 - u1 of an Fq2 element: the operands of its Karatsuba
// and square products.
struct Fq2Sums {
  uint32_t s[12], d[12];
  __device__ __forceinline__ explicit Fq2Sums(const Fq2E& u) {
    fp_add<Fq>(s, u.c0, u.c1);
    fp_sub<Fq>(d, u.c0, u.c1);
  }
};

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

// add-2007-bl on G1 for finite operands, the formula of _point_add_kernel
// (pallas :272) and jac_add; `same` is H == 0 and r == 0 (P == Q, where
// the result is the formula's and the caller doubles instead).
template <int L>
__device__ __forceinline__ void add_formula(Jac<G1Field>& o, bool& same,
                                            const Jac<G1Field>& p,
                                            const Jac<G1Field>& q, int sub,
                                            int base) {
  const uint32_t *X1 = p.X.v, *Y1 = p.Y.v, *Z1 = p.Z.v;
  const uint32_t *X2 = q.X.v, *Y2 = q.Y.v, *Z2 = q.Z.v;
  uint32_t l1[4][12];                    // Z1Z1, Z2Z2, Y1 Z2, Y2 Z1
  {
    const uint32_t* const a[4] = {Z1, Z2, Y1, Y2};
    const uint32_t* const b[4] = {Z1, Z2, Z2, Z1};
    spread_products<L, 4>(l1, a, b, sub, base);
  }
  uint32_t l2[4][12];                    // U1, U2, S1, S2
  {
    const uint32_t* const a[4] = {X1, X2, l1[2], l1[3]};
    const uint32_t* const b[4] = {l1[1], l1[0], l1[1], l1[0]};
    spread_products<L, 4>(l2, a, b, sub, base);
  }
  uint32_t H[12], r[12], H2[12], r2[12], ZZ[12];
  fp_sub<Fq>(H, l2[1], l2[0]);
  fp_sub<Fq>(r, l2[3], l2[2]);
  same = limbs_zero<12>(H) && limbs_zero<12>(r);
  fp_add<Fq>(H2, H, H);
  fp_add<Fq>(r2, r, r);
  fp_add<Fq>(ZZ, Z1, Z2);
  uint32_t l3[3][12];                    // I = (2H)^2, (2r)^2, (Z1 + Z2)^2
  {
    const uint32_t* const a[3] = {H2, r2, ZZ};
    spread_products<L, 3>(l3, a, a, sub, base);
  }
  uint32_t Zm[12];
  fp_sub<Fq>(Zm, l3[2], l1[0]);
  fp_sub<Fq>(Zm, Zm, l1[1]);
  uint32_t l4[3][12];                    // J = H I, V = U1 I, Z3
  {
    const uint32_t* const a[3] = {H, l2[0], Zm};
    const uint32_t* const b[3] = {l3[0], l3[0], H};
    spread_products<L, 3>(l4, a, b, sub, base);
  }
  uint32_t t[12], w[12];
  fp_sub<Fq>(t, l3[1], l4[0]);
  fp_add<Fq>(w, l4[1], l4[1]);
  fp_sub<Fq>(o.X.v, t, w);
  fp_sub<Fq>(w, l4[1], o.X.v);
  uint32_t l5[2][12];                    // S1 J, r2 (V - X3)
  {
    const uint32_t* const a[2] = {l2[2], r2};
    const uint32_t* const b[2] = {l4[0], w};
    spread_products<L, 2>(l5, a, b, sub, base);
  }
  fp_add<Fq>(t, l5[0], l5[0]);
  fp_sub<Fq>(o.Y.v, l5[1], t);
  copy_limbs<12>(o.Z.v, l4[2]);
}

// add-2007-bl on G2: the same levels, each Fq2 product as three Fq
// products (Karatsuba) and each square as two.
template <int L>
__device__ __forceinline__ void add_formula(Jac<G2Field>& o, bool& same,
                                            const Jac<G2Field>& p,
                                            const Jac<G2Field>& q, int sub,
                                            int base) {
  const Fq2E &X1 = p.X, &Y1 = p.Y, &Z1 = p.Z;
  const Fq2E &X2 = q.X, &Y2 = q.Y, &Z2 = q.Z;
  Fq2E Z1Z1, Z2Z2, A1, A2;
  {
    const Fq2Sums z1(Z1), z2(Z2), y1(Y1), y2(Y2);
    uint32_t l1[10][12];   // Z1^2, Z2^2 (two each), Y1 Z2, Y2 Z1 (three)
    const uint32_t* const a[10] = {z1.s, Z1.c0, z2.s, Z2.c0, Y1.c0,
                                   Y1.c1, y1.s, Y2.c0, Y2.c1, y2.s};
    const uint32_t* const b[10] = {z1.d, Z1.c1, z2.d, Z2.c1, Z2.c0,
                                   Z2.c1, z2.s, Z1.c0, Z1.c1, z1.s};
    spread_products<L, 10, false>(l1, a, b, sub, base);
    fq2_from_square(Z1Z1, l1[0], l1[1]);
    fq2_from_square(Z2Z2, l1[2], l1[3]);
    fq2_from_kara(A1, l1[4], l1[5], l1[6]);
    fq2_from_kara(A2, l1[7], l1[8], l1[9]);
  }
  Fq2E U1, U2, S1, S2;
  {
    const Fq2Sums x1(X1), x2(X2), zz1(Z1Z1), zz2(Z2Z2), a1(A1), a2(A2);
    uint32_t l2[12][12];   // U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1, S2
    const uint32_t* const a[12] = {X1.c0, X1.c1, x1.s, X2.c0, X2.c1, x2.s,
                                   A1.c0, A1.c1, a1.s, A2.c0, A2.c1, a2.s};
    const uint32_t* const b[12] = {Z2Z2.c0, Z2Z2.c1, zz2.s, Z1Z1.c0,
                                   Z1Z1.c1, zz1.s,  Z2Z2.c0, Z2Z2.c1,
                                   zz2.s,  Z1Z1.c0, Z1Z1.c1, zz1.s};
    spread_products<L, 12, false>(l2, a, b, sub, base);
    fq2_from_kara(U1, l2[0], l2[1], l2[2]);
    fq2_from_kara(U2, l2[3], l2[4], l2[5]);
    fq2_from_kara(S1, l2[6], l2[7], l2[8]);
    fq2_from_kara(S2, l2[9], l2[10], l2[11]);
  }
  Fq2E H, r, H2, r2, ZZ;
  fq2_sub(H, U2, U1);
  fq2_sub(r, S2, S1);
  same = G2Field::is_zero(H) && G2Field::is_zero(r);
  fq2_add(H2, H, H);
  fq2_add(r2, r, r);
  fq2_add(ZZ, Z1, Z2);
  const Fq2Sums rs(r2);
  Fq2E I, rr, Zm;
  {
    const Fq2Sums h2(H2), zz(ZZ);
    uint32_t l3[6][12];    // I = (2H)^2, (2r)^2, (Z1 + Z2)^2
    const uint32_t* const a[6] = {h2.s, H2.c0, rs.s, r2.c0, zz.s, ZZ.c0};
    const uint32_t* const b[6] = {h2.d, H2.c1, rs.d, r2.c1, zz.d, ZZ.c1};
    spread_products<L, 6, false>(l3, a, b, sub, base);
    fq2_from_square(I, l3[0], l3[1]);
    fq2_from_square(rr, l3[2], l3[3]);
    fq2_from_square(Zm, l3[4], l3[5]);
    fq2_sub(Zm, Zm, Z1Z1);
    fq2_sub(Zm, Zm, Z2Z2);
  }
  Fq2E J, V;
  {
    const Fq2Sums h(H), i(I), u1(U1), zm(Zm);
    uint32_t l4[9][12];    // J = H I, V = U1 I, Z3 = Zm H
    const uint32_t* const a[9] = {H.c0, H.c1, h.s, U1.c0, U1.c1, u1.s,
                                  Zm.c0, Zm.c1, zm.s};
    const uint32_t* const b[9] = {I.c0, I.c1, i.s, I.c0, I.c1, i.s,
                                  H.c0, H.c1, h.s};
    spread_products<L, 9, false>(l4, a, b, sub, base);
    fq2_from_kara(J, l4[0], l4[1], l4[2]);
    fq2_from_kara(V, l4[3], l4[4], l4[5]);
    fq2_from_kara(o.Z, l4[6], l4[7], l4[8]);
  }
  Fq2E t, w;
  fq2_sub(t, rr, J);
  fq2_add(w, V, V);
  fq2_sub(o.X, t, w);
  fq2_sub(w, V, o.X);
  {
    const Fq2Sums s1(S1), j(J), ws(w);
    uint32_t l5[6][12];    // S1 J, r2 (V - X3)
    const uint32_t* const a[6] = {S1.c0, S1.c1, s1.s, r2.c0, r2.c1, rs.s};
    const uint32_t* const b[6] = {J.c0, J.c1, j.s, w.c0, w.c1, ws.s};
    spread_products<L, 6, false>(l5, a, b, sub, base);
    Fq2E s1j, ym;
    fq2_from_kara(s1j, l5[0], l5[1], l5[2]);
    fq2_from_kara(ym, l5[3], l5[4], l5[5]);
    fq2_add(t, s1j, s1j);
    fq2_sub(o.Y, ym, t);
  }
}

// madd-2007-bl on G1 for finite operands, the formula of _madd_core
// (pallas :567) and jac_madd: Jacobian p plus affine (qx, qy); `same` as
// in add_formula.
template <int L>
__device__ __forceinline__ void madd_formula(Jac<G1Field>& o, bool& same,
                                             const Jac<G1Field>& p,
                                             const FqE& qx, const FqE& qy,
                                             int sub, int base) {
  const uint32_t *X1 = p.X.v, *Y1 = p.Y.v, *Z1 = p.Z.v;
  uint32_t l1[1][12];                    // Z1Z1
  {
    const uint32_t* const a[1] = {Z1};
    spread_products<L, 1>(l1, a, a, sub, base);
  }
  uint32_t l2[2][12];                    // U2 = X2 Z1Z1, Z1 Z1Z1
  {
    const uint32_t* const a[2] = {qx.v, Z1};
    const uint32_t* const b[2] = {l1[0], l1[0]};
    spread_products<L, 2>(l2, a, b, sub, base);
  }
  uint32_t H[12], ZH[12];
  fp_sub<Fq>(H, l2[0], X1);
  fp_add<Fq>(ZH, Z1, H);
  uint32_t l3[3][12];                    // S2 = Y2 Z1^3, HH, (Z1 + H)^2
  {
    const uint32_t* const a[3] = {qy.v, H, ZH};
    const uint32_t* const b[3] = {l2[1], H, ZH};
    spread_products<L, 3>(l3, a, b, sub, base);
  }
  uint32_t r[12], r2[12], I[12];
  fp_sub<Fq>(r, l3[0], Y1);
  same = limbs_zero<12>(H) && limbs_zero<12>(r);
  fp_add<Fq>(r2, r, r);
  fp_add<Fq>(I, l3[1], l3[1]);
  fp_add<Fq>(I, I, I);
  uint32_t l4[3][12];                    // J = H I, V = X1 I, r2^2
  {
    const uint32_t* const a[3] = {H, X1, r2};
    const uint32_t* const b[3] = {I, I, r2};
    spread_products<L, 3>(l4, a, b, sub, base);
  }
  uint32_t t[12], w[12];
  fp_sub<Fq>(t, l4[2], l4[0]);
  fp_add<Fq>(w, l4[1], l4[1]);
  fp_sub<Fq>(o.X.v, t, w);
  fp_sub<Fq>(w, l4[1], o.X.v);
  uint32_t l5[2][12];                    // Y1 J, r2 (V - X3)
  {
    const uint32_t* const a[2] = {Y1, r2};
    const uint32_t* const b[2] = {l4[0], w};
    spread_products<L, 2>(l5, a, b, sub, base);
  }
  fp_add<Fq>(t, l5[0], l5[0]);
  fp_sub<Fq>(o.Y.v, l5[1], t);
  fp_sub<Fq>(t, l3[2], l1[0]);
  fp_sub<Fq>(o.Z.v, t, l3[1]);
}

// madd-2007-bl on G2.
template <int L>
__device__ __forceinline__ void madd_formula(Jac<G2Field>& o, bool& same,
                                             const Jac<G2Field>& p,
                                             const Fq2E& qx, const Fq2E& qy,
                                             int sub, int base) {
  const Fq2E &X1 = p.X, &Y1 = p.Y, &Z1 = p.Z;
  const Fq2Sums z1(Z1);
  Fq2E Z1Z1;
  {
    uint32_t l1[2][12];    // Z1^2
    const uint32_t* const a[2] = {z1.s, Z1.c0};
    const uint32_t* const b[2] = {z1.d, Z1.c1};
    spread_products<L, 2, false>(l1, a, b, sub, base);
    fq2_from_square(Z1Z1, l1[0], l1[1]);
  }
  Fq2E U2, ZC;
  {
    const Fq2Sums x2(qx), zz(Z1Z1);
    uint32_t l2[6][12];    // U2 = X2 Z1Z1, Z1 Z1Z1
    const uint32_t* const a[6] = {qx.c0, qx.c1, x2.s, Z1.c0, Z1.c1, z1.s};
    const uint32_t* const b[6] = {Z1Z1.c0, Z1Z1.c1, zz.s, Z1Z1.c0,
                                  Z1Z1.c1, zz.s};
    spread_products<L, 6, false>(l2, a, b, sub, base);
    fq2_from_kara(U2, l2[0], l2[1], l2[2]);
    fq2_from_kara(ZC, l2[3], l2[4], l2[5]);
  }
  Fq2E H, ZH, S2, HH, ZH2;
  fq2_sub(H, U2, X1);
  fq2_add(ZH, Z1, H);
  const Fq2Sums h(H);
  {
    const Fq2Sums y2(qy), zc(ZC), zh(ZH);
    uint32_t l3[7][12];    // S2 = Y2 Z1^3 (three), HH, (Z1 + H)^2 (two each)
    const uint32_t* const a[7] = {qy.c0, qy.c1, y2.s, h.s, H.c0, zh.s,
                                  ZH.c0};
    const uint32_t* const b[7] = {ZC.c0, ZC.c1, zc.s, h.d, H.c1, zh.d,
                                  ZH.c1};
    spread_products<L, 7, false>(l3, a, b, sub, base);
    fq2_from_kara(S2, l3[0], l3[1], l3[2]);
    fq2_from_square(HH, l3[3], l3[4]);
    fq2_from_square(ZH2, l3[5], l3[6]);
  }
  Fq2E r, r2, I;
  fq2_sub(r, S2, Y1);
  same = G2Field::is_zero(H) && G2Field::is_zero(r);
  fq2_add(r2, r, r);
  fq2_add(I, HH, HH);
  fq2_add(I, I, I);
  const Fq2Sums rs(r2);
  Fq2E J, V, rr;
  {
    const Fq2Sums i(I), x1(X1);
    uint32_t l4[8][12];    // J = H I, V = X1 I (three each), r2^2 (two)
    const uint32_t* const a[8] = {H.c0, H.c1, h.s, X1.c0, X1.c1, x1.s,
                                  rs.s, r2.c0};
    const uint32_t* const b[8] = {I.c0, I.c1, i.s, I.c0, I.c1, i.s,
                                  rs.d, r2.c1};
    spread_products<L, 8, false>(l4, a, b, sub, base);
    fq2_from_kara(J, l4[0], l4[1], l4[2]);
    fq2_from_kara(V, l4[3], l4[4], l4[5]);
    fq2_from_square(rr, l4[6], l4[7]);
  }
  Fq2E t, w;
  fq2_sub(t, rr, J);
  fq2_add(w, V, V);
  fq2_sub(o.X, t, w);
  fq2_sub(w, V, o.X);
  {
    const Fq2Sums y1(Y1), j(J), ws(w);
    uint32_t l5[6][12];    // Y1 J, r2 (V - X3)
    const uint32_t* const a[6] = {Y1.c0, Y1.c1, y1.s, r2.c0, r2.c1, rs.s};
    const uint32_t* const b[6] = {J.c0, J.c1, j.s, w.c0, w.c1, ws.s};
    spread_products<L, 6, false>(l5, a, b, sub, base);
    Fq2E yj, ym;
    fq2_from_kara(yj, l5[0], l5[1], l5[2]);
    fq2_from_kara(ym, l5[3], l5[4], l5[5]);
    fq2_add(t, yj, yj);
    fq2_sub(o.Y, ym, t);
  }
  fq2_sub(t, ZH2, Z1Z1);
  fq2_sub(o.Z, t, HH);
}

// The full add with jac_add's special cases, on L lanes a point (every
// lane of the warp calls it; lane sub of the group at lane base): q at
// infinity gives p, p at infinity gives q, P == Q the doubling.
template <class G, int L>
__device__ __forceinline__ void add_lanes(Jac<G>& out, const Jac<G>& p,
                                          const Jac<G>& q, int sub, int base) {
  if constexpr (L == 1) {
    jac_add<G>(out, p, q);
  } else {
    Jac<G> r;
    bool same;
    add_formula<L>(r, same, p, q, sub, base);
    const bool p_inf = G::is_zero(p.Z), q_inf = G::is_zero(q.Z);
    if (same && !p_inf && !q_inf) jac_double<G>(r, p);
    if (p_inf) r = q;
    if (q_inf) r = p;
    out = r;
  }
}

// add_lanes where some lanes add nothing (`need` false: q at infinity):
// a warp none of whose lanes needs the add skips the formula, as
// jac_add's early return does at L = 1 (a Hillis-Steele round whose
// segments have all ended, a carry add that takes no carry).
template <class G, int L>
__device__ __forceinline__ void add_lanes_if(Jac<G>& out, const Jac<G>& p,
                                             const Jac<G>& q, bool need,
                                             int sub, int base) {
  if constexpr (L > 1) {
    if (!__any_sync(kFull, need)) {
      out = p;
      return;
    }
  }
  add_lanes<G, L>(out, p, q, sub, base);
}

// K3's mixed add with the doubling case resolved, as K3 followed by K2's
// fix-up (ops.curve.point_madd): q = (0, 0) gives p, p at infinity gives
// (qx, qy, 1), P == Q the doubling of p.
template <class G, int L>
__device__ __forceinline__ void madd_lanes(Jac<G>& out, const Jac<G>& p,
                                           const typename G::E& qx,
                                           const typename G::E& qy, int sub,
                                           int base) {
  Jac<G> r;
  bool same;
  madd_formula<L>(r, same, p, qx, qy, sub, base);
  const bool p_inf = G::is_zero(p.Z);
  const bool q_inf = G::is_zero(qx) && G::is_zero(qy);
  same = same && !p_inf && !q_inf;
  if (p_inf) {
    r.X = qx;
    r.Y = qy;
    G::set_one(r.Z);
  }
  if (q_inf) r = p;
  if (same) jac_double<G>(r, p);
  out = r;
}

// The lane's place in its group of L lanes: P = 32 / L points a warp, the
// lanes past the last group idle (they run along for the shuffles).
template <int L>
struct LaneGroup {
  static constexpr int P = 32 / L;
  int g, sub, base;
  __device__ __forceinline__ LaneGroup() {
    const int lane = threadIdx.x & 31;
    g = lane / L;
    sub = lane - g * L;
    base = g * L;
  }
  // the point of this lane's group, counting from the first thread of
  // the grid
  __device__ __forceinline__ int64_t point() const {
    return (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * P + g;
  }
  __device__ __forceinline__ bool in_group() const { return g < P; }
};

template <class G>
__device__ __forceinline__ void jac_zero(Jac<G>& p) {
  G::set_zero(p.X);
  G::set_zero(p.Y);
  G::set_zero(p.Z);
}

}  // namespace zk
