// Montgomery arithmetic over Fr (8 x u32) and Fq (12 x u32), and Fq2.
//
// Counterpart of the in-kernel bodies of zukelang_tpu/ops/pallas_kernels.py
// (_fq_mul_body :43, _fq_add_body :84, _fq_sub_body :105, _fq2_*_body
// :378-398).  The TPU has no 64-bit multiply and works in 16-bit limbs; here
// each step is a 32x32->64 product.  The Montgomery radix is the same
// (2^256 for Fr, 2^384 for Fq) and every result is canonical (< p), so the
// values equal the JAX package's bit for bit after repacking.
//
// The constants below are params.FR / params.FQ (p, R mod p, -p^-1 mod 2^32);
// tests/test_torch_field.py checks them against zukelang_tpu_torch.params.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

static __constant__ uint32_t kFrP[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t kFrOne[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
static __constant__ uint32_t kFqP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t kFqOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Fr {
  static constexpr int NL = 8;
  static constexpr uint32_t NPRIME = 0xffffffffu;
  __device__ static __forceinline__ uint32_t p(int i) { return kFrP[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kFrOne[i]; }
};

struct Fq {
  static constexpr int NL = 12;
  static constexpr uint32_t NPRIME = 0xfffcfffdu;
  __device__ static __forceinline__ uint32_t p(int i) { return kFqP[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kFqOne[i]; }
};

// r = a * b * R^-1 mod p (CIOS).  Inputs < p; t < 2p before the final
// conditional subtraction.  r may alias a or b: it is written last.
template <class F>
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  constexpr int N = F::NL;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c = (uint64_t)a[j] * bi + t[j] + (c >> 32);
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
  const bool ge = t[N] >= borrow;  // t - p did not go negative
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

// One CIOS step's product row on t (N + 2 words, t[N + 1] taking the
// carry): t += a bk.  The low halves of the limb products in one PTX carry
// chain, the high halves in another: ptxas lowers each limb product to
// four instructions (IMAD, IMAD.HI, two IADD3.X).
template <class F>
__device__ __forceinline__ void cios_mac(uint32_t (&t)[F::NL + 2],
                                         const uint32_t (&a)[F::NL],
                                         uint32_t bk) {
  if constexpr (F::NL == 12) {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %14, %26, %0;\n\t"
        "madc.lo.cc.u32 %1, %15, %26, %1;\n\t"
        "madc.lo.cc.u32 %2, %16, %26, %2;\n\t"
        "madc.lo.cc.u32 %3, %17, %26, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %26, %4;\n\t"
        "madc.lo.cc.u32 %5, %19, %26, %5;\n\t"
        "madc.lo.cc.u32 %6, %20, %26, %6;\n\t"
        "madc.lo.cc.u32 %7, %21, %26, %7;\n\t"
        "madc.lo.cc.u32 %8, %22, %26, %8;\n\t"
        "madc.lo.cc.u32 %9, %23, %26, %9;\n\t"
        "madc.lo.cc.u32 %10, %24, %26, %10;\n\t"
        "madc.lo.cc.u32 %11, %25, %26, %11;\n\t"
        "addc.cc.u32 %12, %12, 0;\n\t"
        "addc.u32 %13, %13, 0;\n\t"
        "mad.hi.cc.u32 %1, %14, %26, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %26, %2;\n\t"
        "madc.hi.cc.u32 %3, %16, %26, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %26, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %26, %5;\n\t"
        "madc.hi.cc.u32 %6, %19, %26, %6;\n\t"
        "madc.hi.cc.u32 %7, %20, %26, %7;\n\t"
        "madc.hi.cc.u32 %8, %21, %26, %8;\n\t"
        "madc.hi.cc.u32 %9, %22, %26, %9;\n\t"
        "madc.hi.cc.u32 %10, %23, %26, %10;\n\t"
        "madc.hi.cc.u32 %11, %24, %26, %11;\n\t"
        "madc.hi.cc.u32 %12, %25, %26, %12;\n\t"
        "addc.u32 %13, %13, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]),
          "r"(bk));
  } else {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(bk));
  }
}

// One CIOS step's reduction: with m = t[0] NPRIME, t = (t + m p) / 2^32,
// written one word down in place (N + 1 words, t[N + 1] dead); p's limbs
// in registers.
template <class F>
__device__ __forceinline__ void cios_redc(uint32_t (&t)[F::NL + 2],
                                          const uint32_t (&p)[F::NL]) {
  const uint32_t m = t[0] * F::NPRIME;
  if constexpr (F::NL == 12) {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %14, %15, %0;\n\t"
        "madc.lo.cc.u32 %0, %14, %16, %1;\n\t"
        "madc.lo.cc.u32 %1, %14, %17, %2;\n\t"
        "madc.lo.cc.u32 %2, %14, %18, %3;\n\t"
        "madc.lo.cc.u32 %3, %14, %19, %4;\n\t"
        "madc.lo.cc.u32 %4, %14, %20, %5;\n\t"
        "madc.lo.cc.u32 %5, %14, %21, %6;\n\t"
        "madc.lo.cc.u32 %6, %14, %22, %7;\n\t"
        "madc.lo.cc.u32 %7, %14, %23, %8;\n\t"
        "madc.lo.cc.u32 %8, %14, %24, %9;\n\t"
        "madc.lo.cc.u32 %9, %14, %25, %10;\n\t"
        "madc.lo.cc.u32 %10, %14, %26, %11;\n\t"
        "addc.cc.u32 %11, %12, 0;\n\t"
        "addc.u32 %12, %13, 0;\n\t"
        "mad.hi.cc.u32 %0, %14, %15, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, %16, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %14, %19, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %20, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %21, %6;\n\t"
        "madc.hi.cc.u32 %7, %14, %22, %7;\n\t"
        "madc.hi.cc.u32 %8, %14, %23, %8;\n\t"
        "madc.hi.cc.u32 %9, %14, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %14, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %14, %26, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(m), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]),
          "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]),
          "r"(p[11]));
  } else {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
        "madc.lo.cc.u32 %0, %10, %12, %1;\n\t"
        "madc.lo.cc.u32 %1, %10, %13, %2;\n\t"
        "madc.lo.cc.u32 %2, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %3, %10, %15, %4;\n\t"
        "madc.lo.cc.u32 %4, %10, %16, %5;\n\t"
        "madc.lo.cc.u32 %5, %10, %17, %6;\n\t"
        "madc.lo.cc.u32 %6, %10, %18, %7;\n\t"
        "addc.cc.u32 %7, %8, 0;\n\t"
        "addc.u32 %8, %9, 0;\n\t"
        "mad.hi.cc.u32 %0, %10, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.hi.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %10, %18, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(m), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]),
          "r"(p[5]), "r"(p[6]), "r"(p[7]));
  }
}

// r = a + b mod p (either domain).
template <class F>
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  constexpr int N = F::NL;
  uint32_t s[N], d[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c = (uint64_t)a[j] + b[j] + (c >> 32);
    s[j] = (uint32_t)c;
  }
  const uint32_t top = (uint32_t)(c >> 32);
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t x = (uint64_t)s[j] - F::p(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = top >= borrow;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : s[j];
}

// r = a - b mod p.
template <class F>
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b) {
  constexpr int N = F::NL;
  uint32_t d[N], f[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t x = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c = (uint64_t)d[j] + F::p(j) + (c >> 32);
    f[j] = (uint32_t)c;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = borrow ? f[j] : d[j];
}

template <int N>
__device__ __forceinline__ bool limbs_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) acc |= a[j];
  return acc == 0;
}

// ---------------------------------------------------------------------------
// Coordinate fields of the two groups, as the curve templates use them.
// An element loads from a limb-major column: row j at base[j * stride].
// ---------------------------------------------------------------------------

struct FqE {
  uint32_t v[12];
};

struct Fq2E {
  uint32_t c0[12];
  uint32_t c1[12];
};

// Out of line: one copy of the product per kernel keeps the point formulas
// small enough to compile in seconds.
static __device__ __noinline__ void fq_mul_call(uint32_t* r, const uint32_t* a,
                                                const uint32_t* b) {
  fp_mul<Fq>(r, a, b);
}

struct G1Field {
  using E = FqE;
  static constexpr int ROWS = 12;
  __device__ static __forceinline__ void mul(E& r, const E& a, const E& b) {
    fq_mul_call(r.v, a.v, b.v);
  }
  __device__ static __forceinline__ void add(E& r, const E& a, const E& b) {
    fp_add<Fq>(r.v, a.v, b.v);
  }
  __device__ static __forceinline__ void sub(E& r, const E& a, const E& b) {
    fp_sub<Fq>(r.v, a.v, b.v);
  }
  __device__ static __forceinline__ bool is_zero(const E& a) {
    return limbs_zero<12>(a.v);
  }
  __device__ static __forceinline__ void set_zero(E& r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.v[j] = 0;
  }
  __device__ static __forceinline__ void set_one(E& r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.v[j] = Fq::one(j);
  }
  __device__ static __forceinline__ void load(E& r, const uint32_t* base,
                                              int64_t stride) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.v[j] = base[j * stride];
  }
  __device__ static __forceinline__ void store(uint32_t* base, int64_t stride,
                                               const E& a) {
#pragma unroll
    for (int j = 0; j < 12; ++j) base[j * stride] = a.v[j];
  }
};

// Fq2 = Fq[u]/(u^2 + 1); Karatsuba product as _fq2_mul_body (pallas :378).
static __device__ __forceinline__ void fq2_mul(Fq2E& r, const Fq2E& a,
                                               const Fq2E& b) {
  uint32_t v0[12], v1[12], sa[12], sb[12], t[12];
  fp_mul<Fq>(v0, a.c0, b.c0);
  fp_mul<Fq>(v1, a.c1, b.c1);
  fp_add<Fq>(sa, a.c0, a.c1);
  fp_add<Fq>(sb, b.c0, b.c1);
  fp_mul<Fq>(t, sa, sb);
  fp_sub<Fq>(r.c0, v0, v1);
  fp_sub<Fq>(t, t, v0);
  fp_sub<Fq>(r.c1, t, v1);
}

static __device__ __noinline__ void fq2_mul_call(Fq2E& r, const Fq2E& a,
                                                 const Fq2E& b) {
  fq2_mul(r, a, b);
}

struct G2Field {
  using E = Fq2E;
  static constexpr int ROWS = 24;
  __device__ static __forceinline__ void mul(E& r, const E& a, const E& b) {
    fq2_mul_call(r, a, b);
  }
  __device__ static __forceinline__ void add(E& r, const E& a, const E& b) {
    fp_add<Fq>(r.c0, a.c0, b.c0);
    fp_add<Fq>(r.c1, a.c1, b.c1);
  }
  __device__ static __forceinline__ void sub(E& r, const E& a, const E& b) {
    fp_sub<Fq>(r.c0, a.c0, b.c0);
    fp_sub<Fq>(r.c1, a.c1, b.c1);
  }
  __device__ static __forceinline__ bool is_zero(const E& a) {
    return limbs_zero<12>(a.c0) && limbs_zero<12>(a.c1);
  }
  __device__ static __forceinline__ void set_zero(E& r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.c0[j] = r.c1[j] = 0;
  }
  __device__ static __forceinline__ void set_one(E& r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      r.c0[j] = Fq::one(j);
      r.c1[j] = 0;
    }
  }
  __device__ static __forceinline__ void load(E& r, const uint32_t* base,
                                              int64_t stride) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      r.c0[j] = base[j * stride];
      r.c1[j] = base[(12 + j) * stride];
    }
  }
  __device__ static __forceinline__ void store(uint32_t* base, int64_t stride,
                                               const E& a) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      base[j * stride] = a.c0[j];
      base[(12 + j) * stride] = a.c1[j];
    }
  }
};

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace zk
