// The port's copy of native/zukelang_native.cpp, the JAX package's host
// backend: BLS12-381 Fr/Fq arithmetic, G1 curve ops, Pippenger MSM, a
// radix-2 NTT over Fr and the optimal ate pairing.  The port calls only the
// pairing (zukelang_tpu_torch/native.py builds and loads this file).
//
// Plays the role blst's C library plays for the OCaml reference
// (dune-project:23, curve.ml:74-221): the fast *host-side*
// crypto substrate.  The device path owns the large-scale prove
// workloads; this library serves host-resident work: witness-side field
// batches, CRS (de)serialization, cross-checking the device kernels, and
// small/latency-sensitive MSMs where a device round-trip is not worth it.
//
// ABI: extern "C", all field elements little-endian byte arrays in
// standard (non-Montgomery) form: Fr = 32 bytes, Fq = 48 bytes.  Points
// are affine (x, y, infinity_flag) unless stated.
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

// CIOS Montgomery multiply
template <int N>
static inline Fp<N> fp_mul(const Fp<N> &a, const Fp<N> &b,
                           const FpParams<N> &P) {
  u64 t[N + 2];
  memset(t, 0, sizeof(t));
  for (int i = 0; i < N; i++) {
    u64 carry = 0;
    for (int j = 0; j < N; j++) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    u128 s = (u128)t[N] + carry;
    t[N] = (u64)s;
    t[N + 1] = (u64)(s >> 64);

    u64 m = t[0] * P.ninv;
    u128 s2 = (u128)t[0] + (u128)m * P.mod[0];
    carry = (u64)(s2 >> 64);
    for (int j = 1; j < N; j++) {
      u128 ss = (u128)t[j] + (u128)m * P.mod[j] + carry;
      t[j - 1] = (u64)ss;
      carry = (u64)(ss >> 64);
    }
    s2 = (u128)t[N] + carry;
    t[N - 1] = (u64)s2;
    t[N] = t[N + 1] + (u64)(s2 >> 64);
    t[N + 1] = 0;
  }
  Fp<N> r;
  memcpy(r.v, t, sizeof(r.v));
  if (t[N] || fp_geq<N>(r.v, P.mod)) fp_sub_mod<N>(r.v, P.mod);
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
// G1 (Jacobian over Fq, Montgomery form coordinates)
// ---------------------------------------------------------------------------

struct G1 {
  Fq x, y, z;  // z == 0 -> infinity
};

static inline bool g1_is_inf(const G1 &p) { return fp_is_zero<6>(p.z); }

static G1 g1_double(const G1 &p) {
  if (g1_is_inf(p) || fp_is_zero<6>(p.y)) {
    G1 r;
    r.x = p.x;
    r.y = p.y;
    r.z = Fq::zero();
    return r;
  }
  Fq A = fp_sqr<6>(p.x, FQ);
  Fq B = fp_sqr<6>(p.y, FQ);
  Fq C = fp_sqr<6>(B, FQ);
  Fq t = fp_add<6>(p.x, B, FQ);
  Fq D = fp_sub<6>(fp_sub<6>(fp_sqr<6>(t, FQ), A, FQ), C, FQ);
  D = fp_add<6>(D, D, FQ);
  Fq E = fp_add<6>(fp_add<6>(A, A, FQ), A, FQ);
  Fq F = fp_sqr<6>(E, FQ);
  G1 r;
  r.x = fp_sub<6>(F, fp_add<6>(D, D, FQ), FQ);
  Fq c8 = fp_add<6>(C, C, FQ);
  c8 = fp_add<6>(c8, c8, FQ);
  c8 = fp_add<6>(c8, c8, FQ);
  r.y = fp_sub<6>(fp_mul<6>(E, fp_sub<6>(D, r.x, FQ), FQ), c8, FQ);
  Fq yz = fp_mul<6>(p.y, p.z, FQ);
  r.z = fp_add<6>(yz, yz, FQ);
  return r;
}

static G1 g1_add(const G1 &p, const G1 &q) {
  if (g1_is_inf(p)) return q;
  if (g1_is_inf(q)) return p;
  Fq z1z1 = fp_sqr<6>(p.z, FQ);
  Fq z2z2 = fp_sqr<6>(q.z, FQ);
  Fq u1 = fp_mul<6>(p.x, z2z2, FQ);
  Fq u2 = fp_mul<6>(q.x, z1z1, FQ);
  Fq s1 = fp_mul<6>(fp_mul<6>(p.y, q.z, FQ), z2z2, FQ);
  Fq s2 = fp_mul<6>(fp_mul<6>(q.y, p.z, FQ), z1z1, FQ);
  Fq h = fp_sub<6>(u2, u1, FQ);
  Fq rr = fp_sub<6>(s2, s1, FQ);
  if (fp_is_zero<6>(h)) {
    if (fp_is_zero<6>(rr)) return g1_double(p);
    G1 inf;
    inf.x = p.x;
    inf.y = p.y;
    inf.z = Fq::zero();
    return inf;
  }
  Fq h2 = fp_add<6>(h, h, FQ);
  Fq i = fp_sqr<6>(h2, FQ);
  Fq j = fp_mul<6>(h, i, FQ);
  Fq r2 = fp_add<6>(rr, rr, FQ);
  Fq v = fp_mul<6>(u1, i, FQ);
  G1 r;
  r.x = fp_sub<6>(fp_sub<6>(fp_sqr<6>(r2, FQ), j, FQ),
                  fp_add<6>(v, v, FQ), FQ);
  Fq s1j = fp_mul<6>(s1, j, FQ);
  r.y = fp_sub<6>(fp_mul<6>(r2, fp_sub<6>(v, r.x, FQ), FQ),
                  fp_add<6>(s1j, s1j, FQ), FQ);
  Fq zs = fp_sqr<6>(fp_add<6>(p.z, q.z, FQ), FQ);
  r.z = fp_mul<6>(fp_sub<6>(fp_sub<6>(zs, z1z1, FQ), z2z2, FQ), h, FQ);
  return r;
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

// ---- G1 ops ---------------------------------------------------------------
// affine point encoding: 48B x, 48B y, 1B infinity (standard form coords)

static G1 read_g1_affine(const uint8_t *in) {
  G1 p;
  Fq x, y;
  read_fq(in, &x);
  read_fq(in + 48, &y);
  uint8_t inf = in[96];
  if (inf) {
    p.x = fp_to_mont<6>(x, FQ);
    p.y = fp_to_mont<6>(y, FQ);
    p.z = Fq::zero();
  } else {
    p.x = fp_to_mont<6>(x, FQ);
    p.y = fp_to_mont<6>(y, FQ);
    Fq one = Fq::zero();
    one.v[0] = 1;
    p.z = fp_to_mont<6>(one, FQ);
  }
  return p;
}

static void write_g1_affine(const G1 &p, uint8_t *out) {
  if (g1_is_inf(p)) {
    memset(out, 0, 97);
    out[96] = 1;
    return;
  }
  Fq zi = fp_inv<6>(p.z, FQ);
  Fq zi2 = fp_sqr<6>(zi, FQ);
  Fq x = fp_mul<6>(p.x, zi2, FQ);
  Fq y = fp_mul<6>(fp_mul<6>(p.y, zi2, FQ), zi, FQ);
  write_fq(fp_from_mont<6>(x, FQ), out);
  write_fq(fp_from_mont<6>(y, FQ), out + 48);
  out[96] = 0;
}

void g1_scalar_mul(const uint8_t *point, const uint8_t *scalar,
                   uint8_t *out) {
  G1 p = read_g1_affine(point);
  Fr s;
  read_fr(scalar, &s);
  G1 acc;
  acc.x = Fq::zero();
  acc.y = Fq::zero();
  acc.z = Fq::zero();
  bool started = false;
  for (int i = 3; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) acc = g1_double(acc);
      if ((s.v[i] >> b) & 1) {
        if (!started) {
          acc = p;
          started = true;
        } else {
          acc = g1_add(acc, p);
        }
      }
    }
  }
  write_g1_affine(acc, out);
}

// Pippenger MSM: points n*97B affine, scalars n*32B -> one affine point.
void g1_msm(const uint8_t *points, const uint8_t *scalars, int64_t n,
            uint8_t *out) {
  const int c = 8;
  const int windows = (255 + c - 1) / c;
  std::vector<G1> pts(n);
  std::vector<Fr> scs(n);
  for (int64_t i = 0; i < n; i++) {
    pts[i] = read_g1_affine(points + 97 * i);
    read_fr(scalars + 32 * i, &scs[i]);
  }
  G1 total;
  total.z = Fq::zero();
  bool total_set = false;
  for (int w = windows - 1; w >= 0; w--) {
    if (total_set)
      for (int d = 0; d < c; d++) total = g1_double(total);
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
        buckets[digit] = g1_add(buckets[digit], pts[i]);
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
          run = g1_add(run, buckets[b]);
        else {
          run = buckets[b];
          run_set = true;
        }
      }
      if (run_set) {
        if (acc_set)
          acc = g1_add(acc, run);
        else {
          acc = run;
          acc_set = true;
        }
      }
    }
    if (acc_set) {
      if (total_set)
        total = g1_add(total, acc);
      else {
        total = acc;
        total_set = true;
      }
    }
  }
  if (!total_set) total.z = Fq::zero();
  write_g1_affine(total, out);
}

int native_abi_version() { return 1; }


}  // extern "C"

// ---------------------------------------------------------------------------
// Fq2 / Fq6 / Fq12 tower and the optimal ate pairing.
//
// Tower matches zukelang_tpu_torch.golden.field (the oracle):
//   Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - xi), xi = u+1; Fq12 = Fq6[w]/(w^2 - v).
// The reference reaches pairing through blst (curve.ml:64-72 Pairing); this
// is the native verify-side equivalent (golden/pairing.py semantics).
// ---------------------------------------------------------------------------

struct Fq2v { Fq c0, c1; };
struct Fq6v { Fq2v c0, c1, c2; };
struct Fq12v { Fq6v c0, c1; };

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

static void read_fq2(const uint8_t *in, Fq2v *out) {
  Fq a, b;
  read_fq(in, &a);
  read_fq(in + 48, &b);
  out->c0 = fp_to_mont<6>(a, FQ);
  out->c1 = fp_to_mont<6>(b, FQ);
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
    read_fq2(g2 + i * 192, &qx);
    read_fq2(g2 + i * 192 + 96, &qy);
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
  read_fq2(g2, &qx);
  read_fq2(g2 + 96, &qy);
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

