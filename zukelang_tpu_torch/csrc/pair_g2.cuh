// G2 arithmetic on thread pairs: threads 2j and 2j + 1 of a warp hold one
// G2 value together, thread h its Fq component h of every Fq2 coordinate.
// Shared by the G2 kernels that run on pairs: K5 (bucket_scan_g2.cu), K7
// (jac_scan_g2.cu) and K6 (weighted_sums_g2.cu).
//
// Products split evenly over the pair with lazy reduction (pair_mul, one
// CIOS pass over two 12 x 12 products a thread: 432 limb products, 864 a
// pair against Karatsuba's three Fq products); a square is one Fq product
// a thread (pair_sqr).  Sums and differences are per component, and every
// result is canonical, so a formula on pairs gives the words of the same
// formula on whole Fq2 values (field.cuh's G2Field).  Predicates over an
// Fq2 value are one shuffle (pair_all): both threads of a pair always
// take the same branch, and every shuffle names only its pair.
//
// The Jacobian full add and doubling (pair_add, pair_dbl) read their
// operands from memory, component h of each coordinate loaded where the
// formula multiplies it, and return the result in registers: a point is
// 36 words a thread, and two operands held through add-2007-bl's
// temporaries would not fit the registers of 12 warps an SM.
#pragma once

#include "field.cuh"

namespace zk {

// The lanes of this thread's pair in its warp.
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << (threadIdx.x & 30u);
}

__device__ __forceinline__ uint32_t partner(unsigned m, uint32_t v) {
  return __shfl_xor_sync(m, v, 1);
}

// v on both threads of the pair (both threads always shuffle).
__device__ __forceinline__ bool pair_all(unsigned m, bool v) {
  const uint32_t o = partner(m, v ? 1u : 0u);
  return v && o != 0;
}

// r = t - p if t >= p, else t, for t[0..12] < 2p.
__device__ __forceinline__ void cond_sub_p(FqE& r, const uint32_t (&t)[14]) {
  uint32_t s[12];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const uint64_t x = (uint64_t)t[j] - Fq::p(j) - borrow;
    s[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = t[12] >= borrow;
#pragma unroll
  for (int j = 0; j < 12; ++j) r.v[j] = ge ? s[j] : t[j];
}

// field.cuh's cios_redc<Fq> with p's limbs (params.FQ) as immediate
// operands, so that the products hold no registers for p: it took K7's G2
// kernel from 200 B of spill to none at 168 registers, and left K5's time
// as it was (PERF.md, section 6).
__device__ __forceinline__ void cios_redc_imm(uint32_t (&t)[14]) {
  const uint32_t m = t[0] * Fq::NPRIME;
  asm("{\n\t"
      "mad.lo.cc.u32 %0, %14, 0xffffaaab, %0;\n\t"
      "madc.lo.cc.u32 %0, %14, 0xb9feffff, %1;\n\t"
      "madc.lo.cc.u32 %1, %14, 0xb153ffff, %2;\n\t"
      "madc.lo.cc.u32 %2, %14, 0x1eabfffe, %3;\n\t"
      "madc.lo.cc.u32 %3, %14, 0xf6b0f624, %4;\n\t"
      "madc.lo.cc.u32 %4, %14, 0x6730d2a0, %5;\n\t"
      "madc.lo.cc.u32 %5, %14, 0xf38512bf, %6;\n\t"
      "madc.lo.cc.u32 %6, %14, 0x64774b84, %7;\n\t"
      "madc.lo.cc.u32 %7, %14, 0x434bacd7, %8;\n\t"
      "madc.lo.cc.u32 %8, %14, 0x4b1ba7b6, %9;\n\t"
      "madc.lo.cc.u32 %9, %14, 0x397fe69a, %10;\n\t"
      "madc.lo.cc.u32 %10, %14, 0x1a0111ea, %11;\n\t"
      "addc.cc.u32 %11, %12, 0;\n\t"
      "addc.u32 %12, %13, 0;\n\t"
      "mad.hi.cc.u32 %0, %14, 0xffffaaab, %0;\n\t"
      "madc.hi.cc.u32 %1, %14, 0xb9feffff, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, 0xb153ffff, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, 0x1eabfffe, %3;\n\t"
      "madc.hi.cc.u32 %4, %14, 0xf6b0f624, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, 0x6730d2a0, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, 0xf38512bf, %6;\n\t"
      "madc.hi.cc.u32 %7, %14, 0x64774b84, %7;\n\t"
      "madc.hi.cc.u32 %8, %14, 0x434bacd7, %8;\n\t"
      "madc.hi.cc.u32 %9, %14, 0x4b1ba7b6, %9;\n\t"
      "madc.hi.cc.u32 %10, %14, 0x397fe69a, %10;\n\t"
      "madc.hi.cc.u32 %11, %14, 0x1a0111ea, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      "\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
      : "r"(m));
}

// Component h of the Fq2 product a b, a and b holding component h.
//   h = 0: REDC(a0 b0 + a1 (p - b1)) = a0 b0 - a1 b1
//   h = 1: REDC(a1 b0 + a0 b1)
// as x y + z w with x = a_h and z = a_(1-h) resident, y and w streamed:
// one CIOS pass on t that adds x y_i + z w_i and reduces one word a step
// (field.cuh's cios_mac and cios_redc_imm above: carry chains, which
// inlined compile to fewer registers than the same sums in 64-bit C
// arithmetic).  t stays below 4p between steps (x, z < p), and ends at
// REDC(x y + z w) < 2p.  r may alias a or b.
__device__ __forceinline__ void pair_mul(FqE& r, const FqE& a, const FqE& b,
                                         uint32_t h, unsigned m) {
  uint32_t z[12], t[14], p[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    z[j] = partner(m, a.v[j]);
    p[j] = Fq::p(j);
  }
#pragma unroll
  for (int j = 0; j < 14; ++j) t[j] = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint32_t bo = partner(m, b.v[i]);
    const uint64_t d = (uint64_t)p[i] - bo - borrow;       // p - b1
    borrow = (uint32_t)(d >> 63);
    const uint32_t y = h ? bo : b.v[i];
    const uint32_t w = h ? b.v[i] : (uint32_t)d;
    t[13] = 0;
    cios_mac<Fq>(t, a.v, y);
    cios_mac<Fq>(t, z, w);
    cios_redc_imm(t);
  }
  cond_sub_p(r, t);
}

// r = x y R^-1 mod p, canonical, for canonical x, y: fp_mul's CIOS on
// the carry chains.
__device__ __forceinline__ void chain_mul(FqE& r, const uint32_t (&x)[12],
                                          const uint32_t (&y)[12]) {
  uint32_t t[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    t[13] = 0;
    cios_mac<Fq>(t, x, y[i]);
    cios_redc_imm(t);
  }
  cond_sub_p(r, t);
}

// Component h of a^2: h = 0 (a0 + a1)(a0 - a1), h = 1 2 a0 a1.  Out of
// line, operand and result by value (in registers).
static __device__ __noinline__ FqE pair_sqr(const FqE a, uint32_t h, unsigned m) {
  FqE r;
  uint32_t o[12], x[12], y[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) o[j] = partner(m, a.v[j]);
  fp_add<Fq>(x, a.v, o);
  fp_sub<Fq>(y, a.v, o);
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    x[j] = h ? a.v[j] : x[j];
    y[j] = h ? o[j] : y[j];
  }
  chain_mul(r, x, y);
  fp_add<Fq>(x, r.v, r.v);
#pragma unroll
  for (int j = 0; j < 12; ++j) r.v[j] = h ? x[j] : r.v[j];
  return r;
}

// Sums, differences and zero tests of one component (an Fq value).
__device__ __forceinline__ void fq_add(FqE& r, const FqE& a, const FqE& b) {
  fp_add<Fq>(r.v, a.v, b.v);
}

__device__ __forceinline__ void fq_sub(FqE& r, const FqE& a, const FqE& b) {
  fp_sub<Fq>(r.v, a.v, b.v);
}

__device__ __forceinline__ bool fq_is_zero(const FqE& a) {
  return limbs_zero<12>(a.v);
}

// Component h of the Fq2 one (Montgomery form) or of zero.
__device__ __forceinline__ void h_one_or_zero(FqE& r, bool one, uint32_t h) {
#pragma unroll
  for (int j = 0; j < 12; ++j) r.v[j] = one && !h ? Fq::one(j) : 0u;
}

// Component h of a G2 Jacobian point.
struct PairJac {
  FqE X, Y, Z;
};

// Component h (12 words at word 12 h) of coordinate rows (2, 12, ncols):
// rows 12 h .. 12 h + 11 of column col.
__device__ __forceinline__ void h_store(uint32_t* base, int64_t col,
                                        int64_t ncols, uint32_t h,
                                        const FqE& a) {
  uint32_t* p = base + (int64_t)(12 * h) * ncols + col;
#pragma unroll
  for (int j = 0; j < 12; ++j) p[j * ncols] = a.v[j];
}

// pair_mul out of line, operands and result by value (in registers): one
// copy of the pass serves every product of the add and the doubling.
static __device__ __noinline__ FqE pmul(const FqE a, const FqE b, uint32_t h,
                                 unsigned m) {
  FqE r;
  pair_mul(r, a, b, h, m);
  return r;
}

// Component h of a G2 Jacobian point in memory: word j of coordinate X at
// x[j s], of Y at y[j s], of Z at z[j s].  A column of (2, 12, n)
// coordinates: x = X + 12 h n + col, s = n; a thread's slot in shared
// memory: s = the block's threads.  A single zero word with s = 0 is the
// all-zero point.
struct PairPt {
  const uint32_t* x;
  const uint32_t* y;
  const uint32_t* z;
  int64_t s;
};

__device__ __forceinline__ void pair_ld(FqE& r, const uint32_t* c,
                                        int64_t s) {
#pragma unroll
  for (int j = 0; j < 12; ++j) r.v[j] = c[j * s];
}

__device__ __forceinline__ void pair_st(uint32_t* c, int64_t s,
                                        const FqE& a) {
#pragma unroll
  for (int j = 0; j < 12; ++j) c[j * s] = a.v[j];
}

__device__ __forceinline__ void pair_ld_point(PairJac& r, const PairPt& p) {
  pair_ld(r.X, p.x, p.s);
  pair_ld(r.Y, p.y, p.s);
  pair_ld(r.Z, p.z, p.s);
}

// out = 2 P: dbl-2009-l (a = 0) on components, jac_double<G2Field>
// (curve.cuh): A = X^2, B = Y^2, C = B^2, D = 2 ((X + B)^2 - A - C),
// E = 3 A, X3 = E^2 - 2 D, Y3 = E (D - X3) - 8 C, Z3 = 2 Y Z.  5 squares
// and 2 products: 2,304 limb products a thread.
__device__ __forceinline__ void pair_dbl(PairJac& out, const PairPt& P,
                                         uint32_t h, unsigned m) {
  FqE a, A, B, C, D;
  pair_ld(a, P.x, P.s);
  A = pair_sqr(a, h, m);
  pair_ld(a, P.y, P.s);
  B = pair_sqr(a, h, m);
  C = pair_sqr(B, h, m);
  pair_ld(a, P.x, P.s);
  fq_add(a, a, B);
  a = pair_sqr(a, h, m);
  fq_sub(a, a, A);
  fq_sub(a, a, C);
  fq_add(D, a, a);
  fq_add(a, A, A);
  fq_add(A, a, A);                           // E
  B = pair_sqr(A, h, m);                     // E^2
  fq_add(a, D, D);
  fq_sub(out.X, B, a);
  fq_add(C, C, C);
  fq_add(C, C, C);
  fq_add(C, C, C);                           // 8 C
  fq_sub(a, D, out.X);
  B = pmul(A, a, h, m);
  fq_sub(out.Y, B, C);
  pair_ld(a, P.y, P.s);
  pair_ld(B, P.z, P.s);
  B = pmul(a, B, h, m);
  fq_add(out.Z, B, B);
}

// out = P + Q: add-2007-bl with every special case of jac_add<G2Field>
// (curve.cuh): Q if P is infinity, P if Q is, the doubling of P if P == Q
// (H = 0 and S2 - S1 = 0), and the formula's own infinity (Z3 = 0) if
// P == -Q.  Z3 = 2 Z1 Z2 H, which equals add-2007-bl's ((Z1 + Z2)^2 -
// Z1Z1 - Z2Z2) H in the field, so Z1Z1 and Z2Z2 die once S1 and S2 are
// formed.  12 products and 4 squares: 6,336 limb products a thread,
// 12,672 a pair, against 13,824 for the 48 Fq products of one thread's
// Karatsuba form.  At most five components live in registers across a
// product besides its operands.
__device__ __forceinline__ void pair_add(PairJac& out, const PairPt& P,
                                         const PairPt& Q, uint32_t h,
                                         unsigned m) {
  FqE a, b;
  pair_ld(a, P.z, P.s);
  pair_ld(b, Q.z, Q.s);
  const bool p_inf = pair_all(m, fq_is_zero(a));
  const bool q_inf = pair_all(m, fq_is_zero(b));
  if (q_inf) {
    pair_ld_point(out, P);
    return;
  }
  if (p_inf) {
    pair_ld_point(out, Q);
    return;
  }
  FqE Z1Z1, U1, H, S1, r;
  Z1Z1 = pair_sqr(a, h, m);
  {
    const FqE Z2Z2 = pair_sqr(b, h, m);
    pair_ld(a, P.x, P.s);
    U1 = pmul(a, Z2Z2, h, m);
    pair_ld(a, P.y, P.s);
    a = pmul(a, b, h, m);                    // Y1 Z2
    S1 = pmul(a, Z2Z2, h, m);
  }
  pair_ld(a, Q.x, Q.s);
  H = pmul(a, Z1Z1, h, m);
  fq_sub(H, H, U1);                          // U2 - U1
  pair_ld(a, Q.y, Q.s);
  pair_ld(b, P.z, P.s);
  a = pmul(a, b, h, m);                      // Y2 Z1
  r = pmul(a, Z1Z1, h, m);
  fq_sub(r, r, S1);                          // S2 - S1
  if (pair_all(m, fq_is_zero(H) && fq_is_zero(r))) {
    pair_dbl(out, P, h, m);
    return;
  }
  pair_ld(a, P.z, P.s);
  pair_ld(b, Q.z, Q.s);
  a = pmul(a, b, h, m);                      // Z1 Z2
  a = pmul(a, H, h, m);
  fq_add(out.Z, a, a);                       // Z3 = 2 Z1 Z2 H
  fq_add(a, H, H);
  a = pair_sqr(a, h, m);                     // I = (2 H)^2
  b = pmul(H, a, h, m);                      // J
  a = pmul(U1, a, h, m);                     // V
  fq_add(r, r, r);                           // r2
  H = pair_sqr(r, h, m);
  fq_sub(H, H, b);
  fq_add(U1, a, a);
  fq_sub(out.X, H, U1);                      // X3 = r2^2 - J - 2 V
  S1 = pmul(S1, b, h, m);
  fq_add(S1, S1, S1);
  fq_sub(a, a, out.X);
  a = pmul(r, a, h, m);
  fq_sub(out.Y, a, S1);                      // Y3 = r2 (V - X3) - 2 S1 J
}

}  // namespace zk
