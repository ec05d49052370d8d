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
