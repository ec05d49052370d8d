// The port's copy of native/zukelang_native.cpp, the JAX package's host
// backend: BLS12-381 Fr/Fq arithmetic, G1 curve ops, Pippenger MSM, a
// radix-2 NTT over Fr and the optimal ate pairing; beyond it, the G2 group
// law, the Groth16 proof assembly and the Pinocchio ZK fold.
// zukelang_tpu_torch/native.py builds and loads this file and binds the Fr
// batches, the NTT, G1 and G2 scalar multiplication, the G1 MSM, the G2
// addition, the Groth16 proof assembly, the Pinocchio ZK fold and the
// pairing; the Groth16 provers assemble their proofs here, the Pinocchio
// ZK provers fold theirs, and the protocols verify through the pairing.
//
// Plays the role blst's C library plays for the OCaml reference
// (dune-project:23, curve.ml:74-221): the fast *host-side*
// crypto substrate.  The device path owns the large-scale prove
// workloads; this library serves host-resident work: witness-side field
// batches, CRS (de)serialization, cross-checking the device kernels, and
// small/latency-sensitive MSMs where a device round-trip is not worth it.
//
// ABI: extern "C", all field elements little-endian byte arrays in
// standard (non-Montgomery) form: Fr = 32 bytes, Fq = 48 bytes, Fq2 = 96
// bytes (c0, c1).  Points are affine (x, y, infinity_flag) unless stated:
// G1 97 bytes, G2 193 bytes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libzukelang_native.so \
//        zukelang_native.cpp   (driven by zukelang_tpu_torch/native.py)

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Generic N-limb Montgomery field
// ---------------------------------------------------------------------------

template <int N> struct FpParams {
  u64 mod[N];   // modulus, little-endian limbs
  u64 r2[N];    // R^2 mod p
  u64 ninv;     // -p^{-1} mod 2^64
  u64 one[N];   // R mod p (Montgomery 1)
};

// BLS12-381 Fq (6 limbs)
static const FpParams<6> FQ = {
    {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
     0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL},
    {0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
     0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL},
    0x89f3fffcfffcfffdULL,
    {0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL,
     0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}};

// BLS12-381 Fr (4 limbs)
static const FpParams<4> FR = {
    {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL, 0x3339d80809a1d805ULL,
     0x73eda753299d7d48ULL},
    {0xc999e990f3f29c6dULL, 0x2b6cedcb87925c23ULL, 0x05d314967254398fULL,
     0x0748d9d99f59ff11ULL},
    0xfffffffeffffffffULL,
    {0x00000001fffffffeULL, 0x5884b7fa00034802ULL, 0x998c4fefecbc4ff5ULL,
     0x1824b159acc5056fULL}};

template <int N> struct Fp {
  u64 v[N];

  static Fp zero() {
    Fp r;
    memset(r.v, 0, sizeof(r.v));
    return r;
  }
};

template <int N>
static inline bool fp_is_zero(const Fp<N> &a) {
  u64 acc = 0;
  for (int i = 0; i < N; i++) acc |= a.v[i];
  return acc == 0;
}

template <int N>
static inline bool fp_eq(const Fp<N> &a, const Fp<N> &b) {
  u64 acc = 0;
  for (int i = 0; i < N; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

template <int N>
static inline bool fp_geq(const u64 *a, const u64 *m) {
  for (int i = N - 1; i >= 0; i--) {
    if (a[i] > m[i]) return true;
    if (a[i] < m[i]) return false;
  }
  return true;  // equal
}

template <int N>
static inline void fp_sub_mod(u64 *a, const u64 *m) {
  u64 borrow = 0;
  for (int i = 0; i < N; i++) {
    u128 d = (u128)a[i] - m[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

template <int N>
static inline Fp<N> fp_add(const Fp<N> &a, const Fp<N> &b,
                           const FpParams<N> &P) {
  Fp<N> r;
  u64 carry = 0;
  for (int i = 0; i < N; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  if (carry || fp_geq<N>(r.v, P.mod)) fp_sub_mod<N>(r.v, P.mod);
  return r;
}

template <int N>
static inline Fp<N> fp_sub(const Fp<N> &a, const Fp<N> &b,
                           const FpParams<N> &P) {
  Fp<N> r;
  u64 borrow = 0;
  for (int i = 0; i < N; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < N; i++) {
      u128 s = (u128)r.v[i] + P.mod[i] + carry;
      r.v[i] = (u64)s;
      carry = (u64)(s >> 64);
    }
  }
  return r;
}

// CIOS Montgomery multiply without the two extra words: both moduli's top
// limbs are below (2^64 - 1) / 2 - 1 (Fq 0x1a01..., Fr 0x73ed...), so the
// running value stays below 2p and fits N words.
template <int N>
static inline Fp<N> fp_mul(const Fp<N> &a, const Fp<N> &b,
                           const FpParams<N> &P) {
  u64 t[N] = {0};
  for (int i = 0; i < N; i++) {
    u128 x = (u128)a.v[0] * b.v[i] + t[0];
    u64 hi_a = (u64)(x >> 64);
    u64 m = (u64)x * P.ninv;
    u128 y = (u128)m * P.mod[0] + (u64)x;
    u64 hi_c = (u64)(y >> 64);
    for (int j = 1; j < N; j++) {
      x = (u128)a.v[j] * b.v[i] + t[j] + hi_a;
      hi_a = (u64)(x >> 64);
      y = (u128)m * P.mod[j] + (u64)x + hi_c;
      hi_c = (u64)(y >> 64);
      t[j - 1] = (u64)y;
    }
    t[N - 1] = hi_a + hi_c;
  }
  Fp<N> r;
  memcpy(r.v, t, sizeof(r.v));
  if (fp_geq<N>(r.v, P.mod)) fp_sub_mod<N>(r.v, P.mod);
  return r;
}

template <int N>
static inline Fp<N> fp_sqr(const Fp<N> &a, const FpParams<N> &P) {
  return fp_mul<N>(a, a, P);
}

template <int N>
static Fp<N> fp_pow(const Fp<N> &a, const u64 *e, int elimbs,
                    const FpParams<N> &P) {
  Fp<N> result;
  memcpy(result.v, P.one, sizeof(result.v));
  bool started = false;
  for (int i = elimbs - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) result = fp_sqr<N>(result, P);
      if ((e[i] >> b) & 1) {
        if (!started) {
          result = a;
          started = true;
        } else {
          result = fp_mul<N>(result, a, P);
        }
      }
    }
  }
  return result;
}

template <int N>
static Fp<N> fp_inv(const Fp<N> &a, const FpParams<N> &P) {
  // Fermat: a^(p-2)
  u64 e[N];
  memcpy(e, P.mod, sizeof(e));
  // subtract 2
  u64 borrow = 2;
  for (int i = 0; i < N && borrow; i++) {
    u64 before = e[i];
    e[i] -= borrow;
    borrow = (before < borrow) ? 1 : 0;
  }
  return fp_pow<N>(a, e, N, P);
}

// to/from Montgomery
template <int N>
static inline Fp<N> fp_to_mont(const Fp<N> &a, const FpParams<N> &P) {
  Fp<N> r2;
  memcpy(r2.v, P.r2, sizeof(r2.v));
  return fp_mul<N>(a, r2, P);
}

template <int N>
static inline Fp<N> fp_from_mont(const Fp<N> &a, const FpParams<N> &P) {
  Fp<N> one = Fp<N>::zero();
  one.v[0] = 1;
  return fp_mul<N>(a, one, P);
}

typedef Fp<6> Fq;
typedef Fp<4> Fr;

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2+1), Montgomery form coefficients
// ---------------------------------------------------------------------------

struct Fq2v { Fq c0, c1; };

static inline Fq2v fq2_zero() { return {Fq::zero(), Fq::zero()}; }
static inline Fq2v fq2_one() {
  Fq2v r = fq2_zero();
  memcpy(r.c0.v, FQ.one, sizeof(r.c0.v));
  return r;
}
static inline bool fq2_is_zero(const Fq2v &a) {
  return fp_is_zero<6>(a.c0) && fp_is_zero<6>(a.c1);
}
static inline bool fq2_eq(const Fq2v &a, const Fq2v &b) {
  return fp_eq<6>(a.c0, b.c0) && fp_eq<6>(a.c1, b.c1);
}
static inline Fq2v fq2_add(const Fq2v &a, const Fq2v &b) {
  return {fp_add<6>(a.c0, b.c0, FQ), fp_add<6>(a.c1, b.c1, FQ)};
}
static inline Fq2v fq2_sub(const Fq2v &a, const Fq2v &b) {
  return {fp_sub<6>(a.c0, b.c0, FQ), fp_sub<6>(a.c1, b.c1, FQ)};
}
static inline Fq2v fq2_neg(const Fq2v &a) {
  return {fp_sub<6>(Fq::zero(), a.c0, FQ), fp_sub<6>(Fq::zero(), a.c1, FQ)};
}
static inline Fq2v fq2_mul(const Fq2v &a, const Fq2v &b) {
  // Karatsuba over u^2 = -1
  Fq v0 = fp_mul<6>(a.c0, b.c0, FQ);
  Fq v1 = fp_mul<6>(a.c1, b.c1, FQ);
  Fq t = fp_mul<6>(fp_add<6>(a.c0, a.c1, FQ), fp_add<6>(b.c0, b.c1, FQ), FQ);
  return {fp_sub<6>(v0, v1, FQ), fp_sub<6>(fp_sub<6>(t, v0, FQ), v1, FQ)};
}
static inline Fq2v fq2_sqr(const Fq2v &a) {
  Fq t0 = fp_mul<6>(fp_add<6>(a.c0, a.c1, FQ), fp_sub<6>(a.c0, a.c1, FQ), FQ);
  Fq m = fp_mul<6>(a.c0, a.c1, FQ);
  return {t0, fp_add<6>(m, m, FQ)};
}
static inline Fq2v fq2_conj(const Fq2v &a) {
  return {a.c0, fp_sub<6>(Fq::zero(), a.c1, FQ)};
}
static inline Fq2v fq2_inv(const Fq2v &a) {
  Fq norm = fp_add<6>(fp_mul<6>(a.c0, a.c0, FQ), fp_mul<6>(a.c1, a.c1, FQ), FQ);
  Fq ninv = fp_inv<6>(norm, FQ);
  return {fp_mul<6>(a.c0, ninv, FQ),
          fp_sub<6>(Fq::zero(), fp_mul<6>(a.c1, ninv, FQ), FQ)};
}
static Fq2v fq2_pow(const Fq2v &a, const u64 *e, int elimbs) {
  Fq2v result = fq2_one();
  bool started = false;
  for (int i = elimbs - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) result = fq2_sqr(result);
      if ((e[i] >> b) & 1) {
        if (!started) { result = a; started = true; }
        else result = fq2_mul(result, a);
      }
    }
  }
  return result;
}

// The coordinate field's operations under one name for Fq and Fq2, so
// that one group law serves G1 and G2.
static inline Fq f_add(const Fq &a, const Fq &b) { return fp_add<6>(a, b, FQ); }
static inline Fq f_sub(const Fq &a, const Fq &b) { return fp_sub<6>(a, b, FQ); }
static inline Fq f_mul(const Fq &a, const Fq &b) { return fp_mul<6>(a, b, FQ); }
static inline Fq f_sqr(const Fq &a) { return fp_sqr<6>(a, FQ); }
static inline Fq f_inv(const Fq &a) { return fp_inv<6>(a, FQ); }
static inline bool f_is_zero(const Fq &a) { return fp_is_zero<6>(a); }
static inline Fq2v f_add(const Fq2v &a, const Fq2v &b) { return fq2_add(a, b); }
static inline Fq2v f_sub(const Fq2v &a, const Fq2v &b) { return fq2_sub(a, b); }
static inline Fq2v f_mul(const Fq2v &a, const Fq2v &b) { return fq2_mul(a, b); }
static inline Fq2v f_sqr(const Fq2v &a) { return fq2_sqr(a); }
static inline Fq2v f_inv(const Fq2v &a) { return fq2_inv(a); }
static inline bool f_is_zero(const Fq2v &a) { return fq2_is_zero(a); }

// ---------------------------------------------------------------------------
// G1 and G2: Jacobian points over Fq and Fq2 (Montgomery form coordinates)
// ---------------------------------------------------------------------------

template <class F> struct Jac {
  F x, y, z;  // z == 0 -> infinity
};
typedef Jac<Fq> G1;
typedef Jac<Fq2v> G2;

template <class F> static inline bool jac_is_inf(const Jac<F> &p) {
  return f_is_zero(p.z);
}

template <class F> static inline Jac<F> jac_inf(const Jac<F> &p) {
  Jac<F> r = p;
  r.z = F{};
  return r;
}

template <class F> static Jac<F> jac_double(const Jac<F> &p) {
  if (jac_is_inf(p) || f_is_zero(p.y)) return jac_inf(p);
  F A = f_sqr(p.x);
  F B = f_sqr(p.y);
  F C = f_sqr(B);
  F t = f_add(p.x, B);
  F D = f_sub(f_sub(f_sqr(t), A), C);
  D = f_add(D, D);
  F E = f_add(f_add(A, A), A);
  Jac<F> r;
  r.x = f_sub(f_sqr(E), f_add(D, D));
  F c8 = f_add(C, C);
  c8 = f_add(c8, c8);
  c8 = f_add(c8, c8);
  r.y = f_sub(f_mul(E, f_sub(D, r.x)), c8);
  F yz = f_mul(p.y, p.z);
  r.z = f_add(yz, yz);
  return r;
}

// P + Q for every P, Q: infinity operands, P == Q (doubling) and P == -Q
// (infinity) included.
template <class F> static Jac<F> jac_add(const Jac<F> &p, const Jac<F> &q) {
  if (jac_is_inf(p)) return q;
  if (jac_is_inf(q)) return p;
  F z1z1 = f_sqr(p.z);
  F z2z2 = f_sqr(q.z);
  F u1 = f_mul(p.x, z2z2);
  F u2 = f_mul(q.x, z1z1);
  F s1 = f_mul(f_mul(p.y, q.z), z2z2);
  F s2 = f_mul(f_mul(q.y, p.z), z1z1);
  F h = f_sub(u2, u1);
  F rr = f_sub(s2, s1);
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) return jac_double(p);
    return jac_inf(p);
  }
  F h2 = f_add(h, h);
  F i = f_sqr(h2);
  F j = f_mul(h, i);
  F r2 = f_add(rr, rr);
  F v = f_mul(u1, i);
  Jac<F> r;
  r.x = f_sub(f_sub(f_sqr(r2), j), f_add(v, v));
  F s1j = f_mul(s1, j);
  r.y = f_sub(f_mul(r2, f_sub(v, r.x)), f_add(s1j, s1j));
  F zs = f_sqr(f_add(p.z, q.z));
  r.z = f_mul(f_sub(f_sub(zs, z1z1), z2z2), h);
  return r;
}

// Scalar multiplication, fixed 4-bit windows: a table of 0..15 times a
// base, then sum_k scalars[k] * base_k over n bases with shared doublings
// (Straus); scalars are 256-bit standard form.
static const int WIN = 4;
static const int WIN_DIGITS = 256 / WIN;

template <class F> static void jac_table(const Jac<F> &p, Jac<F> *m) {
  m[0] = jac_inf(p);
  m[1] = p;
  for (int d = 2; d < (1 << WIN); d++)
    m[d] = (d & 1) ? jac_add(m[d - 1], p) : jac_double(m[d / 2]);
}

static inline int scalar_digit(const Fr &s, int w) {
  const int per_limb = 64 / WIN;
  return (int)((s.v[w / per_limb] >> (WIN * (w % per_limb))) &
               ((1u << WIN) - 1));
}

template <class F>
static Jac<F> jac_lincomb(const Jac<F> *const *tables, const Fr *scalars,
                          int n) {
  Jac<F> acc = tables[0][0];
  for (int w = WIN_DIGITS - 1; w >= 0; w--) {
    for (int k = 0; k < WIN; k++) acc = jac_double(acc);
    for (int t = 0; t < n; t++) {
      int d = scalar_digit(scalars[t], w);
      if (d) acc = jac_add(acc, tables[t][d]);
    }
  }
  return acc;
}

template <class F> static Jac<F> jac_mul(const Jac<F> &p, const Fr &s) {
  Jac<F> table[1 << WIN];
  jac_table(p, table);
  const Jac<F> *tables[1] = {table};
  return jac_lincomb(tables, &s, 1);
}

// a * b mod r, standard form in and out.
static Fr fr_mul_std(const Fr &a, const Fr &b) {
  return fp_from_mont<4>(
      fp_mul<4>(fp_to_mont<4>(a, FR), fp_to_mont<4>(b, FR), FR), FR);
}

// acc + sum_k scalars[k] * bases[k], the n products on one ladder.
template <class F>
static Jac<F> plus_lincomb(const Jac<F> &acc, const Jac<F> *bases,
                           const Fr *scalars, int n) {
  std::vector<Jac<F>> tables((size_t)n << WIN);
  std::vector<const Jac<F> *> ptrs(n);
  for (int k = 0; k < n; k++) {
    ptrs[k] = &tables[(size_t)k << WIN];
    jac_table(bases[k], &tables[(size_t)k << WIN]);
  }
  return jac_add(acc, jac_lincomb(ptrs.data(), scalars, n));
}

// ---------------------------------------------------------------------------
// C ABI helpers
// ---------------------------------------------------------------------------

static void read_fr(const uint8_t *in, Fr *out) {
  memcpy(out->v, in, 32);
}

static void write_fr(const Fr &a, uint8_t *out) { memcpy(out, a.v, 32); }

static void read_fq(const uint8_t *in, Fq *out) { memcpy(out->v, in, 48); }

static void write_fq(const Fq &a, uint8_t *out) { memcpy(out, a.v, 48); }

// Coordinates: standard form in the bytes, Montgomery form in memory; an
// Fq2 is c0 then c1.
static void read_coord(const uint8_t *in, Fq *out) {
  read_fq(in, out);
  *out = fp_to_mont<6>(*out, FQ);
}
static void read_coord(const uint8_t *in, Fq2v *out) {
  read_coord(in, &out->c0);
  read_coord(in + 48, &out->c1);
}
static void write_coord(const Fq &a, uint8_t *out) {
  write_fq(fp_from_mont<6>(a, FQ), out);
}
static void write_coord(const Fq2v &a, uint8_t *out) {
  write_coord(a.c0, out);
  write_coord(a.c1, out + 48);
}
static inline void set_one(Fq *a) { memcpy(a->v, FQ.one, sizeof(a->v)); }
static inline void set_one(Fq2v *a) { *a = fq2_one(); }

// Affine point encoding: x, y, then an infinity byte: G1 97 B (48 B a
// coordinate), G2 193 B (96 B a coordinate: x.c0, x.c1, y.c0, y.c1).
template <class F> static Jac<F> read_affine(const uint8_t *in) {
  const int W = sizeof(F);
  Jac<F> p;
  read_coord(in, &p.x);
  read_coord(in + W, &p.y);
  set_one(&p.z);
  return in[2 * W] ? jac_inf(p) : p;
}

// One inversion a point.
template <class F> static void write_affine(const Jac<F> &p, uint8_t *out) {
  const int W = sizeof(F);
  if (jac_is_inf(p)) {
    memset(out, 0, 2 * W);
    out[2 * W] = 1;
    return;
  }
  F zi = f_inv(p.z);
  F zi2 = f_sqr(zi);
  write_coord(f_mul(p.x, zi2), out);
  write_coord(f_mul(f_mul(p.y, zi2), zi), out + W);
  out[2 * W] = 0;
}

static const int G1_BYTES = 2 * sizeof(Fq) + 1;
static const int G2_BYTES = 2 * sizeof(Fq2v) + 1;

extern "C" {

// ---- Fr batch ops (standard-form in/out) ----------------------------------

void fr_mul_batch(const uint8_t *a, const uint8_t *b, uint8_t *out,
                  int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    Fr x, y;
    read_fr(a + 32 * i, &x);
    read_fr(b + 32 * i, &y);
    Fr xm = fp_to_mont<4>(x, FR);
    Fr ym = fp_to_mont<4>(y, FR);
    Fr r = fp_from_mont<4>(fp_mul<4>(xm, ym, FR), FR);
    write_fr(r, out + 32 * i);
  }
}

void fr_add_batch(const uint8_t *a, const uint8_t *b, uint8_t *out,
                  int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    Fr x, y;
    read_fr(a + 32 * i, &x);
    read_fr(b + 32 * i, &y);
    Fr r = fp_add<4>(x, y, FR);
    write_fr(r, out + 32 * i);
  }
}

void fr_inv_batch(const uint8_t *a, uint8_t *out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    Fr x;
    read_fr(a + 32 * i, &x);
    if (fp_is_zero<4>(x)) {
      write_fr(Fr::zero(), out + 32 * i);
      continue;
    }
    Fr xm = fp_to_mont<4>(x, FR);
    Fr r = fp_from_mont<4>(fp_inv<4>(xm, FR), FR);
    write_fr(r, out + 32 * i);
  }
}

// ---- NTT over Fr ----------------------------------------------------------
// data: n*32 bytes standard form, in-place; w_bytes: primitive n-th root.

void fr_ntt(uint8_t *data, int64_t logn, const uint8_t *w_bytes,
            int inverse, const uint8_t *n_inv_bytes) {
  int64_t n = 1LL << logn;
  std::vector<Fr> a(n);
  for (int64_t i = 0; i < n; i++) {
    Fr t;
    read_fr(data + 32 * i, &t);
    a[i] = fp_to_mont<4>(t, FR);
  }
  // bit reverse
  for (int64_t i = 0, j = 0; i < n; i++) {
    if (i < j) std::swap(a[i], a[j]);
    int64_t m = n >> 1;
    while (m >= 1 && (j & m)) {
      j ^= m;
      m >>= 1;
    }
    j |= m;
  }
  Fr w_root;
  read_fr(w_bytes, &w_root);
  w_root = fp_to_mont<4>(w_root, FR);
  // stage twiddles: w_n^(n/len)
  for (int64_t len = 2; len <= n; len <<= 1) {
    // wlen = w_root^(n/len)
    Fr wlen = w_root;
    for (int64_t k = len; k < n; k <<= 1) wlen = fp_sqr<4>(wlen, FR);
    for (int64_t i = 0; i < n; i += len) {
      Fr w;
      memcpy(w.v, FR.one, sizeof(w.v));
      for (int64_t j = 0; j < len / 2; j++) {
        Fr u = a[i + j];
        Fr v = fp_mul<4>(a[i + j + len / 2], w, FR);
        a[i + j] = fp_add<4>(u, v, FR);
        a[i + j + len / 2] = fp_sub<4>(u, v, FR);
        w = fp_mul<4>(w, wlen, FR);
      }
    }
  }
  Fr scale;
  bool do_scale = false;
  if (inverse) {
    Fr ninv;
    read_fr(n_inv_bytes, &ninv);
    scale = fp_to_mont<4>(ninv, FR);
    do_scale = true;
  }
  for (int64_t i = 0; i < n; i++) {
    Fr t = a[i];
    if (do_scale) t = fp_mul<4>(t, scale, FR);
    write_fr(fp_from_mont<4>(t, FR), data + 32 * i);
  }
}

// ---- G1 and G2 ops --------------------------------------------------------
// points in the affine encoding above; scalars 32 B standard form.

void g1_scalar_mul(const uint8_t *point, const uint8_t *scalar,
                   uint8_t *out) {
  Fr s;
  read_fr(scalar, &s);
  write_affine(jac_mul(read_affine<Fq>(point), s), out);
}

void g2_scalar_mul(const uint8_t *point, const uint8_t *scalar,
                   uint8_t *out) {
  Fr s;
  read_fr(scalar, &s);
  write_affine(jac_mul(read_affine<Fq2v>(point), s), out);
}

void g2_add(const uint8_t *p, const uint8_t *q, uint8_t *out) {
  write_affine(jac_add(read_affine<Fq2v>(p), read_affine<Fq2v>(q)), out);
}

// Groth16 proof assembly (groth16.ml:123-161) from the CRS's host points,
// the five MSM sums and the prover's r, s (standard form, below the group
// order):
//   a  = alpha + A + delta * r
//   b  = beta_2 + B + delta_2 * s
//   b1 = beta + B1 + delta * s
//   c  = Cmid + H + a * s + b1 * r - delta * (r * s)
// Since b1 * r - delta * (r * s) = (beta + B1) * r, c is formed as
// Cmid + H + a * s + (beta + B1) * r, the same point, with the two
// products on one ladder; delta * s and r * s are never needed.
// crs_g1: alpha, beta, delta; crs_g2: beta_2, delta_2; sums_g1: A, B1, H,
// Cmid; sum_g2: B.  out: a (G1), b (G2), c (G1), affine; the points stay
// Jacobian until then, one inversion an output.
void groth16_assemble(const uint8_t *crs_g1, const uint8_t *crs_g2,
                      const uint8_t *sums_g1, const uint8_t *sum_g2,
                      const uint8_t *r_in, const uint8_t *s_in,
                      uint8_t *out) {
  G1 alpha = read_affine<Fq>(crs_g1);
  G1 beta = read_affine<Fq>(crs_g1 + G1_BYTES);
  G1 delta = read_affine<Fq>(crs_g1 + 2 * G1_BYTES);
  G2 beta2 = read_affine<Fq2v>(crs_g2);
  G2 delta2 = read_affine<Fq2v>(crs_g2 + G2_BYTES);
  G1 sum_a = read_affine<Fq>(sums_g1);
  G1 sum_b1 = read_affine<Fq>(sums_g1 + G1_BYTES);
  G1 sum_h = read_affine<Fq>(sums_g1 + 2 * G1_BYTES);
  G1 sum_cmid = read_affine<Fq>(sums_g1 + 3 * G1_BYTES);
  G2 sum_b = read_affine<Fq2v>(sum_g2);
  Fr r, s;
  read_fr(r_in, &r);
  read_fr(s_in, &s);

  G1 a = jac_add(jac_add(alpha, sum_a), jac_mul(delta, r));
  G2 b = jac_add(jac_add(beta2, sum_b), jac_mul(delta2, s));
  G1 t_a[1 << WIN], t_b1r[1 << WIN];
  jac_table(a, t_a);
  jac_table(jac_add(beta, sum_b1), t_b1r);
  const G1 *c_tables[2] = {t_a, t_b1r};
  const Fr c_scalars[2] = {s, r};
  G1 c = jac_add(jac_add(sum_cmid, sum_h),
                 jac_lincomb(c_tables, c_scalars, 2));

  write_affine(a, out);
  write_affine(b, out + G1_BYTES);
  write_affine(c, out + G1_BYTES + G2_BYTES);
}

// Pinocchio ZK fold (pinocchio.ml:427-514): the ZK proof from the NonZK
// MSM sums, the proving key's single points, the all-variable tails and
// the prover's dv, dw, dy (standard form, below the group order):
//   vv'   = vv + vt dv              ww'   = ww + wt dw (G2)
//   yy'   = yy + yt dy              vavv' = vavv + vavt dv
//   waww' = waww + wawt dw (G2)     yayy' = yayy + yayt dy
//   bvwy' = bvwy + vbt dv + wbt dw + ybt dy
//   h'    = h + V dw + W dv + t1 (dv dw) - g dy,
// V = v_all + sum_i c_i v_tail_i and W = w_all + sum_i c_i w_tail_i over
// the tail columns.  h' is formed as h + v_all dw + w_all dv + t1 (dv dw)
// + g (-dy) + sum_i (v_tail_i (c_i dw) + w_tail_i (c_i dv)), the same
// point, with every product on one ladder; bvwy' on one ladder of three.
// singles_g1: vt, yt, vavt, yayt, vbt, wbt, ybt, t1, g; singles_g2: wt,
// wawt; sums_g1: vv, yy, h, vavv, yayy, bvwy, v_all, w_all; sums_g2: ww,
// waww; tails: v_tail[0..n), then w_tail[0..n); tail_vals: c_0..c_(n-1);
// d: dv, dw, dy.  out: vv, ww, yy, h, vavv, waww, yayy, bvwy (the proof's
// order), affine; one inversion an output.
void pinocchio_zk_fold(const uint8_t *singles_g1, const uint8_t *singles_g2,
                       const uint8_t *sums_g1, const uint8_t *sums_g2,
                       const uint8_t *tails, const uint8_t *tail_vals,
                       int64_t n, const uint8_t *d, uint8_t *out) {
  G1 s1[9], m1[8];
  for (int k = 0; k < 9; k++)
    s1[k] = read_affine<Fq>(singles_g1 + k * G1_BYTES);
  for (int k = 0; k < 8; k++)
    m1[k] = read_affine<Fq>(sums_g1 + k * G1_BYTES);
  G2 s2[2], m2[2];
  for (int k = 0; k < 2; k++) {
    s2[k] = read_affine<Fq2v>(singles_g2 + k * G2_BYTES);
    m2[k] = read_affine<Fq2v>(sums_g2 + k * G2_BYTES);
  }
  Fr dv, dw, dy;
  read_fr(d, &dv);
  read_fr(d + 32, &dw);
  read_fr(d + 64, &dy);
  const G1 &vt = s1[0], &yt = s1[1], &vavt = s1[2], &yayt = s1[3],
           &vbt = s1[4], &wbt = s1[5], &ybt = s1[6], &t1 = s1[7], &g = s1[8];
  const G1 &vv = m1[0], &yy = m1[1], &h = m1[2], &vavv = m1[3],
           &yayy = m1[4], &bvwy = m1[5], &v_all = m1[6], &w_all = m1[7];

  // h' on one ladder: 4 fixed terms, then two a tail column
  std::vector<G1> hb = {v_all, w_all, t1, g};
  std::vector<Fr> hs = {dw, dv, fr_mul_std(dv, dw),
                        fp_sub<4>(Fr::zero(), dy, FR)};
  for (int64_t i = 0; i < n; i++) {
    Fr c;
    read_fr(tail_vals + 32 * i, &c);
    hb.push_back(read_affine<Fq>(tails + G1_BYTES * i));
    hs.push_back(fr_mul_std(c, dw));
    hb.push_back(read_affine<Fq>(tails + G1_BYTES * (n + i)));
    hs.push_back(fr_mul_std(c, dv));
  }
  G1 h2 = plus_lincomb(h, hb.data(), hs.data(), (int)hb.size());
  const G1 bb[3] = {vbt, wbt, ybt};
  const Fr bs[3] = {dv, dw, dy};
  G1 bvwy2 = plus_lincomb(bvwy, bb, bs, 3);

  uint8_t *o = out;
  write_affine(plus_lincomb(vv, &vt, &dv, 1), o);
  o += G1_BYTES;
  write_affine(plus_lincomb(m2[0], &s2[0], &dw, 1), o);
  o += G2_BYTES;
  write_affine(plus_lincomb(yy, &yt, &dy, 1), o);
  o += G1_BYTES;
  write_affine(h2, o);
  o += G1_BYTES;
  write_affine(plus_lincomb(vavv, &vavt, &dv, 1), o);
  o += G1_BYTES;
  write_affine(plus_lincomb(m2[1], &s2[1], &dw, 1), o);
  o += G2_BYTES;
  write_affine(plus_lincomb(yayy, &yayt, &dy, 1), o);
  o += G1_BYTES;
  write_affine(bvwy2, o);
}

// Pippenger MSM: points n*97B affine, scalars n*32B -> one affine point.
void g1_msm(const uint8_t *points, const uint8_t *scalars, int64_t n,
            uint8_t *out) {
  const int c = 8;
  const int windows = (255 + c - 1) / c;
  std::vector<G1> pts(n);
  std::vector<Fr> scs(n);
  for (int64_t i = 0; i < n; i++) {
    pts[i] = read_affine<Fq>(points + G1_BYTES * i);
    read_fr(scalars + 32 * i, &scs[i]);
  }
  G1 total;
  total.z = Fq::zero();
  bool total_set = false;
  for (int w = windows - 1; w >= 0; w--) {
    if (total_set)
      for (int d = 0; d < c; d++) total = jac_double(total);
    std::vector<G1> buckets(1 << c);
    std::vector<bool> used(1 << c, false);
    for (int64_t i = 0; i < n; i++) {
      int bit = w * c;
      int limb = bit / 64;
      int off = bit % 64;
      u64 digit = scs[i].v[limb] >> off;
      if (off + c > 64 && limb + 1 < 4)
        digit |= scs[i].v[limb + 1] << (64 - off);
      digit &= (1u << c) - 1;
      if (!digit) continue;
      if (used[digit])
        buckets[digit] = jac_add(buckets[digit], pts[i]);
      else {
        buckets[digit] = pts[i];
        used[digit] = true;
      }
    }
    G1 run, acc;
    run.z = Fq::zero();
    acc.z = Fq::zero();
    bool run_set = false, acc_set = false;
    for (int b = (1 << c) - 1; b >= 1; b--) {
      if (used[b]) {
        if (run_set)
          run = jac_add(run, buckets[b]);
        else {
          run = buckets[b];
          run_set = true;
        }
      }
      if (run_set) {
        if (acc_set)
          acc = jac_add(acc, run);
        else {
          acc = run;
          acc_set = true;
        }
      }
    }
    if (acc_set) {
      if (total_set)
        total = jac_add(total, acc);
      else {
        total = acc;
        total_set = true;
      }
    }
  }
  if (!total_set) total.z = Fq::zero();
  write_affine(total, out);
}

int native_abi_version() { return 1; }


}  // extern "C"

// ---------------------------------------------------------------------------
// Fq6 / Fq12 tower and the optimal ate pairing.
//
// Tower matches zukelang_tpu_torch.golden.field (the oracle):
//   Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - xi), xi = u+1; Fq12 = Fq6[w]/(w^2 - v).
// The reference reaches pairing through blst (curve.ml:64-72 Pairing); this
// is the native verify-side equivalent (golden/pairing.py semantics).
// ---------------------------------------------------------------------------

// Fq2 is defined above, beside the group law.
struct Fq6v { Fq2v c0, c1, c2; };
struct Fq12v { Fq6v c0, c1; };

static Fq2v XI_V;  // u + 1 (Montgomery), initialized lazily

static inline Fq6v fq6_zero() { return {fq2_zero(), fq2_zero(), fq2_zero()}; }
static inline Fq6v fq6_one() { return {fq2_one(), fq2_zero(), fq2_zero()}; }
static inline Fq6v fq6_add(const Fq6v &a, const Fq6v &b) {
  return {fq2_add(a.c0, b.c0), fq2_add(a.c1, b.c1), fq2_add(a.c2, b.c2)};
}
static inline Fq6v fq6_sub(const Fq6v &a, const Fq6v &b) {
  return {fq2_sub(a.c0, b.c0), fq2_sub(a.c1, b.c1), fq2_sub(a.c2, b.c2)};
}
static inline Fq6v fq6_neg(const Fq6v &a) {
  return {fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2)};
}
static inline Fq6v fq6_mul(const Fq6v &a, const Fq6v &b) {
  Fq2v v0 = fq2_mul(a.c0, b.c0);
  Fq2v v1 = fq2_mul(a.c1, b.c1);
  Fq2v v2 = fq2_mul(a.c2, b.c2);
  Fq2v t12 = fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2));
  Fq2v c0 = fq2_add(v0, fq2_mul(fq2_sub(fq2_sub(t12, v1), v2), XI_V));
  Fq2v t01 = fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1));
  Fq2v c1 = fq2_add(fq2_sub(fq2_sub(t01, v0), v1), fq2_mul(v2, XI_V));
  Fq2v t02 = fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2));
  Fq2v c2 = fq2_sub(fq2_add(fq2_sub(t02, v0), v1), v2);
  return {c0, c1, c2};
}
static inline Fq6v fq6_mul_by_v(const Fq6v &a) {
  return {fq2_mul(a.c2, XI_V), a.c0, a.c1};
}
static inline Fq6v fq6_inv(const Fq6v &a) {
  Fq2v t0 = fq2_sub(fq2_sqr(a.c0), fq2_mul(fq2_mul(a.c1, a.c2), XI_V));
  Fq2v t1 = fq2_sub(fq2_mul(fq2_sqr(a.c2), XI_V), fq2_mul(a.c0, a.c1));
  Fq2v t2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
  Fq2v d = fq2_add(fq2_mul(a.c0, t0),
                   fq2_mul(fq2_add(fq2_mul(a.c2, t1), fq2_mul(a.c1, t2)),
                           XI_V));
  Fq2v dinv = fq2_inv(d);
  return {fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv)};
}

static inline Fq12v fq12_zero() { return {fq6_zero(), fq6_zero()}; }
static inline Fq12v fq12_one() { return {fq6_one(), fq6_zero()}; }
static inline bool fq12_eq(const Fq12v &a, const Fq12v &b) {
  return fq2_eq(a.c0.c0, b.c0.c0) && fq2_eq(a.c0.c1, b.c0.c1) &&
         fq2_eq(a.c0.c2, b.c0.c2) && fq2_eq(a.c1.c0, b.c1.c0) &&
         fq2_eq(a.c1.c1, b.c1.c1) && fq2_eq(a.c1.c2, b.c1.c2);
}
static inline Fq12v fq12_add(const Fq12v &a, const Fq12v &b) {
  return {fq6_add(a.c0, b.c0), fq6_add(a.c1, b.c1)};
}
static inline Fq12v fq12_sub(const Fq12v &a, const Fq12v &b) {
  return {fq6_sub(a.c0, b.c0), fq6_sub(a.c1, b.c1)};
}
static inline Fq12v fq12_mul(const Fq12v &a, const Fq12v &b) {
  Fq6v v0 = fq6_mul(a.c0, b.c0);
  Fq6v v1 = fq6_mul(a.c1, b.c1);
  Fq6v t = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(b.c0, b.c1));
  return {fq6_add(v0, fq6_mul_by_v(v1)), fq6_sub(fq6_sub(t, v0), v1)};
}
static inline Fq12v fq12_sqr(const Fq12v &a) {
  Fq6v m = fq6_mul(a.c0, a.c1);
  Fq6v t = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(a.c0, fq6_mul_by_v(a.c1)));
  return {fq6_sub(fq6_sub(t, m), fq6_mul_by_v(m)), fq6_add(m, m)};
}
static inline Fq12v fq12_conj(const Fq12v &a) { return {a.c0, fq6_neg(a.c1)}; }
static inline Fq12v fq12_inv(const Fq12v &a) {
  Fq6v d = fq6_sub(fq6_mul(a.c0, a.c0), fq6_mul_by_v(fq6_mul(a.c1, a.c1)));
  Fq6v dinv = fq6_inv(d);
  return {fq6_mul(a.c0, dinv), fq6_neg(fq6_mul(a.c1, dinv))};
}

// Frobenius: conjugate each Fq2 coefficient, scale basis monomial w^k by
// gamma_k = xi^(k(p-1)/6) (golden/field.py:379-389).
static Fq2v GAMMA[6];
static bool TOWER_READY = false;

static void tower_init() {
  if (TOWER_READY) return;
  XI_V = fq2_one();
  memcpy(XI_V.c1.v, FQ.one, sizeof(XI_V.c1.v));  // xi = 1 + u
  // e = (p - 1) / 6
  u64 e[6];
  memcpy(e, FQ.mod, sizeof(e));
  e[0] -= 1;  // p is odd, no borrow
  u64 rem = 0;
  for (int i = 5; i >= 0; i--) {
    u128 cur = ((u128)rem << 64) | e[i];
    e[i] = (u64)(cur / 6);
    rem = (u64)(cur % 6);
  }
  GAMMA[0] = fq2_one();
  GAMMA[1] = fq2_pow(XI_V, e, 6);
  for (int i = 2; i < 6; i++) GAMMA[i] = fq2_mul(GAMMA[i - 1], GAMMA[1]);
  TOWER_READY = true;
}

static Fq12v fq12_frobenius(const Fq12v &a) {
  // coefficients in basis {1, v, v^2, w, vw, v^2w} = w^{0,2,4,1,3,5}
  const Fq2v *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                       &a.c1.c0, &a.c1.c1, &a.c1.c2};
  static const int wexp[6] = {0, 2, 4, 1, 3, 5};
  Fq2v out[6];
  for (int i = 0; i < 6; i++) out[i] = fq2_mul(fq2_conj(*cs[i]), GAMMA[wexp[i]]);
  return {{out[0], out[1], out[2]}, {out[3], out[4], out[5]}};
}
static Fq12v fq12_frobenius_n(const Fq12v &a, int n) {
  Fq12v f = a;
  for (int i = 0; i < n; i++) f = fq12_frobenius(f);
  return f;
}
static Fq12v fq12_pow_u64(const Fq12v &a, u64 e) {
  Fq12v result = fq12_one();
  Fq12v base = a;
  while (e) {
    if (e & 1) result = fq12_mul(result, base);
    base = fq12_sqr(base);
    e >>= 1;
  }
  return result;
}

// ---------------------------------------------------------------------------
// Miller loop in untwisted E(Fq12) coordinates (golden/pairing.py layout):
// psi(x, y) = (x / w^2, y / w^3) for the M-type twist.
// ---------------------------------------------------------------------------

static const u64 BLS_X_ABS = 0xd201000000010000ULL;  // |x|; x is negative

struct PtFq12 { Fq12v x, y; };

static Fq12v fq12_of_fq2(const Fq2v &a) {
  Fq12v r = fq12_zero();
  r.c0.c0 = a;
  return r;
}

static void untwist_consts(Fq12v *w2inv, Fq12v *w3inv) {
  Fq12v w2 = fq12_zero();          // w^2 = v
  w2.c0.c1 = fq2_one();
  Fq12v w3 = fq12_zero();          // w^3 = v*w
  w3.c1.c1 = fq2_one();
  *w2inv = fq12_inv(w2);
  *w3inv = fq12_inv(w3);
}

// line through A, B evaluated at P (all in E(Fq12)); subfield scale factors
// vanish under the final exponentiation.
static Fq12v line_eval(const Fq12v &ax, const Fq12v &ay, const Fq12v &bx,
                       const Fq12v &by, const Fq12v &px, const Fq12v &py) {
  if (fq12_eq(ax, bx) && fq12_eq(ay, by)) {
    Fq12v ax2 = fq12_sqr(ax);
    Fq12v three = fq12_add(fq12_add(ax2, ax2), ax2);
    Fq12v twoy = fq12_add(ay, ay);
    Fq12v m = fq12_mul(three, fq12_inv(twoy));
    return fq12_sub(fq12_mul(m, fq12_sub(px, ax)), fq12_sub(py, ay));
  }
  if (fq12_eq(ax, bx)) return fq12_sub(px, ax);
  Fq12v m = fq12_mul(fq12_sub(by, ay), fq12_inv(fq12_sub(bx, ax)));
  return fq12_sub(fq12_mul(m, fq12_sub(px, ax)), fq12_sub(py, ay));
}

static void pt_double(Fq12v *tx, Fq12v *ty) {
  Fq12v x2 = fq12_sqr(*tx);
  Fq12v three = fq12_add(fq12_add(x2, x2), x2);
  Fq12v m = fq12_mul(three, fq12_inv(fq12_add(*ty, *ty)));
  Fq12v nx = fq12_sub(fq12_sub(fq12_sqr(m), *tx), *tx);
  Fq12v ny = fq12_sub(fq12_mul(m, fq12_sub(*tx, nx)), *ty);
  *tx = nx;
  *ty = ny;
}

static void pt_add(Fq12v *tx, Fq12v *ty, const Fq12v &qx, const Fq12v &qy) {
  Fq12v m = fq12_mul(fq12_sub(qy, *ty), fq12_inv(fq12_sub(qx, *tx)));
  Fq12v nx = fq12_sub(fq12_sub(fq12_sqr(m), *tx), qx);
  Fq12v ny = fq12_sub(fq12_mul(m, fq12_sub(*tx, nx)), *ty);
  *tx = nx;
  *ty = ny;
}

// g1 affine (Fq x, y Montgomery), g2 affine (Fq2 x, y Montgomery)
static Fq12v miller_loop_native(const Fq &px_, const Fq &py_, const Fq2v &qx2,
                                const Fq2v &qy2) {
  Fq12v w2inv, w3inv;
  untwist_consts(&w2inv, &w3inv);
  Fq12v qx = fq12_mul(fq12_of_fq2(qx2), w2inv);
  Fq12v qy = fq12_mul(fq12_of_fq2(qy2), w3inv);
  Fq2v px2 = {px_, Fq::zero()};
  Fq2v py2 = {py_, Fq::zero()};
  Fq12v px = fq12_of_fq2(px2);
  Fq12v py = fq12_of_fq2(py2);

  Fq12v f = fq12_one();
  Fq12v tx = qx, ty = qy;
  int msb = 63;
  while (!((BLS_X_ABS >> msb) & 1)) msb--;
  for (int b = msb - 1; b >= 0; b--) {
    f = fq12_mul(fq12_sqr(f), line_eval(tx, ty, tx, ty, px, py));
    pt_double(&tx, &ty);
    if ((BLS_X_ABS >> b) & 1) {
      f = fq12_mul(f, line_eval(tx, ty, qx, qy, px, py));
      pt_add(&tx, &ty, qx, qy);
    }
  }
  return fq12_conj(f);  // x < 0: f_{-x} ~ conj(f_x) up to final exp
}

static Fq12v cyc_pow(const Fq12v &f, u64 e) { return fq12_pow_u64(f, e); }

static Fq12v final_exp_native(const Fq12v &fin) {
  // easy part
  Fq12v f1 = fq12_mul(fq12_conj(fin), fq12_inv(fin));
  Fq12v f = fq12_mul(fq12_frobenius_n(f1, 2), f1);
  // hard part: f^((z-1)^2 (z+p) (z^2+p^2-1) + 3) with z = -|BLS_X|
  // (the BLS12-381 seed is negative): f^z = conj(f^|z|) in the cyclotomic
  // subgroup, so z-1 = -(|z|+1) and each z-power conjugates.
  u64 az = BLS_X_ABS;
  Fq12v t0 = fq12_conj(cyc_pow(f, az + 1));       // f^(z-1)
  t0 = fq12_conj(cyc_pow(t0, az + 1));            // f^((z-1)^2)
  Fq12v t1 = fq12_mul(fq12_conj(cyc_pow(t0, az)), // ^(z+p)
                      fq12_frobenius_n(t0, 1));
  Fq12v t1z = fq12_conj(cyc_pow(t1, az));
  Fq12v t1zz = fq12_conj(cyc_pow(t1z, az));       // t1^(z^2)
  Fq12v t2 = fq12_mul(fq12_mul(t1zz, fq12_frobenius_n(t1, 2)),
                      fq12_conj(t1));             // ^(z^2+p^2-1)
  return fq12_mul(fq12_mul(t2, fq12_sqr(f)), f);
}

extern "C" {

// Multi-pairing: prod_i e(P_i, Q_i) with one shared final exponentiation.
// g1: n * 96 bytes (affine x, y standard LE); g1_inf: n bytes (1 = infinity);
// g2: n * 192 bytes (x.c0, x.c1, y.c0, y.c1); g2_inf: n bytes.
// out: 576 bytes = 12 Fq standard LE in coefficient order
// [c0.c0.c0, c0.c0.c1, c0.c1.c0, c0.c1.c1, c0.c2.c0, c0.c2.c1,
//  c1.c0.c0, c1.c0.c1, c1.c1.c0, c1.c1.c1, c1.c2.c0, c1.c2.c1].
void gt_multi_pairing(const uint8_t *g1, const uint8_t *g1_inf,
                      const uint8_t *g2, const uint8_t *g2_inf, int64_t n,
                      uint8_t *out) {
  tower_init();
  Fq12v f = fq12_one();
  for (int64_t i = 0; i < n; i++) {
    if (g1_inf[i] || g2_inf[i]) continue;
    Fq px, py;
    read_fq(g1 + i * 96, &px);
    read_fq(g1 + i * 96 + 48, &py);
    px = fp_to_mont<6>(px, FQ);
    py = fp_to_mont<6>(py, FQ);
    Fq2v qx, qy;
    read_coord(g2 + i * 192, &qx);
    read_coord(g2 + i * 192 + 96, &qy);
    f = fq12_mul(f, miller_loop_native(px, py, qx, qy));
  }
  f = final_exp_native(f);
  const Fq2v *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                       &f.c1.c0, &f.c1.c1, &f.c1.c2};
  for (int i = 0; i < 6; i++) {
    Fq a = fp_from_mont<6>(cs[i]->c0, FQ);
    Fq b = fp_from_mont<6>(cs[i]->c1, FQ);
    write_fq(a, out + i * 96);
    write_fq(b, out + i * 96 + 48);
  }
}

// debug/bisect: miller loop only (no final exponentiation)
void gt_miller_loop(const uint8_t *g1, const uint8_t *g2, uint8_t *out) {
  tower_init();
  Fq px, py;
  read_fq(g1, &px);
  read_fq(g1 + 48, &py);
  px = fp_to_mont<6>(px, FQ);
  py = fp_to_mont<6>(py, FQ);
  Fq2v qx, qy;
  read_coord(g2, &qx);
  read_coord(g2 + 96, &qy);
  Fq12v f = miller_loop_native(px, py, qx, qy);
  const Fq2v *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                       &f.c1.c0, &f.c1.c1, &f.c1.c2};
  for (int i = 0; i < 6; i++) {
    Fq a = fp_from_mont<6>(cs[i]->c0, FQ);
    Fq b = fp_from_mont<6>(cs[i]->c1, FQ);
    write_fq(a, out + i * 96);
    write_fq(b, out + i * 96 + 48);
  }
}

// debug: dump frobenius gamma constants (12 x 48B standard LE)
void gt_dump_gamma(uint8_t *out) {
  tower_init();
  for (int i = 0; i < 6; i++) {
    Fq a = fp_from_mont<6>(GAMMA[i].c0, FQ);
    Fq b = fp_from_mont<6>(GAMMA[i].c1, FQ);
    write_fq(a, out + i * 96);
    write_fq(b, out + i * 96 + 48);
  }
}

static Fq12v read_fq12_std(const uint8_t *in) {
  Fq12v f;
  Fq2v *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2, &f.c1.c0, &f.c1.c1, &f.c1.c2};
  for (int i = 0; i < 6; i++) {
    Fq a, b;
    read_fq(in + i * 96, &a);
    read_fq(in + i * 96 + 48, &b);
    cs[i]->c0 = fp_to_mont<6>(a, FQ);
    cs[i]->c1 = fp_to_mont<6>(b, FQ);
  }
  return f;
}
static void write_fq12_std(const Fq12v &f, uint8_t *out) {
  const Fq2v *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                       &f.c1.c0, &f.c1.c1, &f.c1.c2};
  for (int i = 0; i < 6; i++) {
    write_fq(fp_from_mont<6>(cs[i]->c0, FQ), out + i * 96);
    write_fq(fp_from_mont<6>(cs[i]->c1, FQ), out + i * 96 + 48);
  }
}

// debug: pieces of the final exponentiation
void gt_debug_op(const uint8_t *in, int32_t op, uint8_t *out) {
  tower_init();
  Fq12v f = read_fq12_std(in);
  Fq12v r;
  switch (op) {
    case 0: r = fq12_inv(f); break;
    case 1: r = fq12_conj(f); break;
    case 2: r = fq12_frobenius_n(f, 1); break;
    case 3: r = fq12_frobenius_n(f, 2); break;
    case 4: r = fq12_mul(f, f); break;
    case 5: r = fq12_sqr(f); break;
    case 6: r = final_exp_native(f); break;
    case 7: r = fq12_pow_u64(f, BLS_X_ABS - 1); break;
    case 8: r = fq12_mul(f, fq12_frobenius_n(f, 1)); break;
    case 9: r = fq12_pow_u64(f, 3); break;
    case 10: r = fq12_pow_u64(f, 65537); break;
    case 11: r = fq12_pow_u64(f, 0xffffffffULL); break;
    case 12: r = fq12_pow_u64(f, 1ULL << 33); break;
    case 13: r = fq12_pow_u64(f, 1ULL << 48); break;
    case 14: r = fq12_pow_u64(f, 1ULL << 63); break;
    case 15: r = fq12_pow_u64(f, 0xd20100000000ffffULL); break;
    default: r = f;
  }
  write_fq12_std(r, out);
}

int native_abi_version_pairing() { return 1; }

}  // extern "C"

