"""The Fq2 arithmetic of K5's G2 kernel (csrc/bucket_scan_g2.cu): a model
of it, word for word on Python integers, and the kernel's own products
held to the same values on the card.

The kernel holds each G2 lane on two threads, one Fq component each.  For
an Fq2 product of Montgomery-form a, b thread 0 forms
REDC(a0 b0 + a1 (p - b1)) and thread 1 REDC(a1 b0 + a0 b1): one CIOS pass
over two products a thread (x y + z w, x and z resident, y and w streamed
one limb a step), then one conditional subtraction.  A square splits as
(a0 + a1)(a0 - a1) on thread 0 and 2 a0 a1 on thread 1.  These tests run
the pass step by step on 32-bit words (the kernel's t holds the same value
after each step; its carry word above the 13th is zero there), check that
no word overflows and that the REDC inputs stay below p 2^384,
and hold the results against the Karatsuba product of field.cuh's
`fq2_mul` (as the one-thread kernel computed it) and the golden Fq2
product.  Those tests run a Python copy of the kernel's pass, not the
kernel: they keep passing whatever bucket_scan_g2.cu or field.cuh's
`cios_mac` / `cios_redc` become.  The kernel is checked on the card:
`test_kernel_pair_products` (marked `gpu`) runs its products, through
`kernels.fq2_pair_products`, on the edge values below and on random
ones, and tests/test_torch_cuda.py holds the whole scan to
`bucket_scan_rows_plain`.  Without a CUDA device those tests skip; the
rest is fast and CPU-only.

The same pair arithmetic serves K7's and K6's G2 kernels
(csrc/jac_scan_g2.cu, csrc/weighted_sums_g2.cu) through pair_g2.cuh's
Jacobian full add (add-2007-bl) and doubling (dbl-2009-l) on pairs.  The
tests below model both step by step on the pair products above, in the
header's order, and hold the words to the one-thread formulas
(`kernels._add` and `_dbl`, the plain versions of the one-thread G2
kernels) and the points to golden sums: P = Q and P = -Q with different
Z, infinity on either side or both (with garbage X and Y), Z = 1 and
Z != 1 on both sides, and random points.
"""

import os
import random
import re

import pytest
import torch

from zukelang_tpu_torch.ops import kernels as K

from zukelang_tpu_torch.golden.curve import G2
from zukelang_tpu_torch.golden.field import Fq2
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.params import FQ, int_to_limbs

P = FQ.p
R = FQ.R
MASK = (1 << 32) - 1
P_LIMBS = int_to_limbs(P, 12)
R_INV = pow(R, -1, P)
ONE = FQ.r_mod_p                     # 1 in Montgomery form


def _value(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def redc(T: int) -> int:
    """T R^-1 mod p before the final subtraction: (T + m p) / R."""
    assert 0 <= T < P * R
    m = (T * (R - pow(P, -1, R))) % R
    out = (T + m * P) // R
    assert out < 2 * P
    return out


def cios_pair(x: int, z: int, y_limbs, w_limbs) -> int:
    """The kernel's pass: t (13 words) += x y_i + z w_i, then one word
    reduced, for i = 0..11; returns t before the conditional subtraction,
    having checked every word the kernel keeps in 32 bits."""
    xl, zl = int_to_limbs(x, 12), int_to_limbs(z, 12)
    t = [0] * 13
    for i in range(12):
        c = 0
        for j in range(12):
            c = xl[j] * y_limbs[i] + t[j] + (c >> 32)
            t[j] = c & MASK
        t[12] = c >> 32
        c = 0
        for j in range(12):
            c = zl[j] * w_limbs[i] + t[j] + (c >> 32)
            t[j] = c & MASK
        t[12] += c >> 32
        assert t[12] <= MASK
        q = (t[0] * FQ.nprime) & MASK
        c = q * P_LIMBS[0] + t[0]
        assert c & MASK == 0
        for j in range(1, 12):
            c = q * P_LIMBS[j] + t[j] + (c >> 32)
            t[j - 1] = c & MASK
        t[11] = t[12] + (c >> 32)
        assert t[11] <= MASK
        assert _value(t[:12]) < 4 * P            # the bound between steps
    return _value(t[:12])


def _canon(t: int) -> int:
    assert t < 2 * P
    return t - P if t >= P else t


def thread_operands(a, b, h):
    """(x, z, y limbs, w limbs) of thread h of the pair; w's limbs of
    p - b1 come with the borrow the kernel carries from limb to limb."""
    a0, a1 = a
    b0, b1 = b
    own_b, partner_b = int_to_limbs(b[h], 12), int_to_limbs(b[1 - h], 12)
    diff, borrow = [], 0
    for i in range(12):
        d = P_LIMBS[i] - partner_b[i] - borrow
        borrow = 1 if d < 0 else 0
        diff.append(d & MASK)
    if h == 0:
        assert _value(diff) == P - b1
        return a0, a1, own_b, diff
    return a1, a0, partner_b, own_b


def pair_mul(a, b):
    """(c0, c1) as the two threads of the kernel form them."""
    out = []
    for h in (0, 1):
        x, z, ys, ws = thread_operands(a, b, h)
        t = cios_pair(x, z, ys, ws)
        assert t == redc(x * _value(ys) + z * _value(ws))
        out.append(_canon(t))
    return tuple(out)


def mont_mul(x: int, y: int) -> int:
    """field.cuh's fp_mul: canonical x y R^-1 for canonical x, y."""
    assert 0 <= x < P and 0 <= y < P
    return _canon(redc(x * y))


def pair_sqr(a):
    """(c0, c1) of a^2: thread 0 (a0 + a1)(a0 - a1), thread 1 2 a0 a1."""
    a0, a1 = a
    c0 = mont_mul((a0 + a1) % P, (a0 - a1) % P)
    c1 = 2 * mont_mul(a1, a0) % P
    return c0, c1


def karatsuba(a, b):
    """field.cuh's fq2_mul, the one-thread kernel's product."""
    v0, v1 = mont_mul(a[0], b[0]), mont_mul(a[1], b[1])
    t = mont_mul((a[0] + a[1]) % P, (b[0] + b[1]) % P)
    return (v0 - v1) % P, (t - v0 - v1) % P


def golden(a, b):
    """The golden Fq2 product of the values a, b stand for (Montgomery
    form x R), back in Montgomery form."""
    ga = Fq2.of_ints(a[0] * R_INV, a[1] * R_INV)
    gb = Fq2.of_ints(b[0] * R_INV, b[1] * R_INV)
    g = ga * gb
    return g.c0.n * R % P, g.c1.n * R % P


def golden_square(a):
    g = Fq2.of_ints(a[0] * R_INV, a[1] * R_INV).square()
    return g.c0.n * R % P, g.c1.n * R % P


U = (0, ONE)                          # u, with u^2 = -1
EDGES = {
    "zero": ((0, 0), (5, 7)),
    "raw_one": ((1, 1), (1, 1)),
    "mont_one": ((ONE, 0), (123456789, P - 2)),
    "p_minus_1": ((P - 1, P - 1), (P - 1, 1)),
    "a_equals_b": ((P - 3, 2 ** 380), (P - 3, 2 ** 380)),
    "a1_b1_p_minus_1": ((17, P - 1), (P - 5, P - 1)),
    "u_squared": (U, U),
    "zero_b1": ((P - 1, P - 1), (P - 1, 0)),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_pair_product_edges(name):
    a, b = EDGES[name]
    got = pair_mul(a, b)
    assert got == karatsuba(a, b) == golden(a, b)
    if name == "u_squared":
        assert got == ((P - ONE) % P, 0)            # u^2 = -1


@pytest.mark.parametrize("name", sorted(EDGES))
def test_pair_square_edges(name):
    a, _b = EDGES[name]
    got = pair_sqr(a)
    assert got == pair_mul(a, a) == karatsuba(a, a) == golden_square(a)


@pytest.mark.parametrize("seed", range(4))
def test_pair_product_random(seed):
    r = random.Random(seed)
    for _ in range(64):
        a = (r.randrange(P), r.randrange(P))
        b = (r.randrange(P), r.randrange(P))
        assert pair_mul(a, b) == karatsuba(a, b) == golden(a, b)
        assert pair_sqr(a) == pair_mul(a, a) == golden_square(a)


@pytest.mark.parametrize("name", sorted(EDGES))
def test_redc_inputs_below_p_times_radix(name):
    """Both threads' REDC inputs, as the kernel forms them and as
    a0 b0 + p^2 - a1 b1 (the same class mod p), lie in [0, p 2^384), as
    do the largest canonical operands'; and they agree after REDC."""
    a, b = EDGES[name]
    (a0, a1), (b0, b1) = a, b
    kernel0, kernel1 = a0 * b0 + a1 * (P - b1), a1 * b0 + a0 * b1
    plain0 = a0 * b0 + P * P - a1 * b1
    worst = 2 * (P - 1) * P
    for s in (kernel0, kernel1, plain0, worst):
        assert 0 <= s < P * R
    assert _canon(redc(kernel0)) == _canon(redc(plain0))


def test_reduction_immediates_are_p():
    """pair_g2.cuh's cios_redc_imm writes p's limbs into its carry chains
    as immediates: the low-half chain and the high-half chain each take
    p's 12 limbs in order, and m is t[0] times Fq's -p^-1 mod 2^32."""
    path = os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "pair_g2.cuh")
    src = open(path).read()
    body = src[src.index("void cios_redc_imm"):]
    body = body[:body.index("\n}\n")]
    lo = [int(x, 16) for x in re.findall(r"mad[c]?\.lo\.cc\.u32 %\d+, %14, "
                                          r"0x([0-9a-f]{8})", body)]
    hi = [int(x, 16) for x in re.findall(r"mad[c]?\.hi\.cc\.u32 %\d+, %14, "
                                          r"0x([0-9a-f]{8})", body)]
    assert lo == hi == P_LIMBS
    assert "t[0] * Fq::NPRIME" in body


def _coords(vals, device):
    """Fq2 values (c0, c1) as words, (2, 12, N) int32."""
    words = [[[(v[c] >> (32 * j)) & MASK for v in vals] for j in range(12)]
             for c in range(2)]
    return torch.tensor(words, dtype=torch.int64).to(torch.int32).to(device)


def _values(t):
    """(2, 12, N) words -> [(c0, c1)], words not reduced."""
    w = (t.cpu().to(torch.int64) & MASK).tolist()
    return [tuple(_value([w[c][j][e] for j in range(12)]) for c in range(2))
            for e in range(t.shape[2])]


def _product_inputs(seed: int, n: int):
    """The edge values, then random ones: n pairs (a, b)."""
    r = random.Random(seed)
    pairs = [EDGES[name] for name in sorted(EDGES)]
    while len(pairs) < n:
        pairs.append(((r.randrange(P), r.randrange(P)),
                      (r.randrange(P), r.randrange(P))))
    return pairs


def test_pair_products_plain():
    """`kernels.fq2_pair_products` on the CPU (the port's plain Fq2
    product and square) gives the golden values."""
    pairs = _product_inputs(1, 24)
    prod, sq = K.fq2_pair_products(_coords([a for a, _ in pairs], "cpu"),
                                   _coords([b for _, b in pairs], "cpu"))
    assert _values(prod) == [golden(a, b) for a, b in pairs]
    assert _values(sq) == [golden_square(a) for a, _ in pairs]


@pytest.mark.gpu
def test_kernel_pair_products():
    """The kernel's own pair products (pair_mul, pair_sqr) on the edge
    values and on random ones, 200 elements (the last block of 64 pairs
    part-filled): canonical words equal to golden; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pairs = _product_inputs(2, 200)
    a = _coords([a for a, _ in pairs], "cuda")
    b = _coords([b for _, b in pairs], "cuda")
    before = K.LAUNCHES["bucket_scan_rows_g2"]
    prod, sq = K.fq2_pair_products(a, b)
    assert K.LAUNCHES["bucket_scan_rows_g2"] == before + 1
    assert _values(prod) == [golden(a, b) for a, b in pairs]
    assert _values(sq) == [golden_square(a) for a, _ in pairs]


# ---------------------------------------------------------------------------
# The Jacobian full add and doubling on pairs (pair_g2.cuh)
# ---------------------------------------------------------------------------

def _fadd(a, b):
    return (a[0] + b[0]) % P, (a[1] + b[1]) % P


def _fsub(a, b):
    return (a[0] - b[0]) % P, (a[1] - b[1]) % P


def _is_zero(a):
    return a == (0, 0)


def pair_dbl_model(pt):
    """pair_dbl: dbl-2009-l (a = 0) in the header's order, every product
    and square as the pair forms it."""
    X, Y, Z = pt
    A = pair_sqr(X)
    B = pair_sqr(Y)
    C_ = pair_sqr(B)
    a = pair_sqr(_fadd(X, B))
    a = _fsub(_fsub(a, A), C_)
    D = _fadd(a, a)
    E = _fadd(_fadd(A, A), A)
    X3 = _fsub(pair_sqr(E), _fadd(D, D))
    c8 = _fadd(C_, C_)
    c8 = _fadd(c8, c8)
    c8 = _fadd(c8, c8)
    Y3 = _fsub(pair_mul(E, _fsub(D, X3)), c8)
    yz = pair_mul(Y, Z)
    return X3, Y3, _fadd(yz, yz)


def pair_add_model(p, q):
    """pair_add: add-2007-bl with jac_add's special cases, in the
    header's order: Q where P is infinity, P where Q is, the doubling of
    P where H = 0 and S2 - S1 = 0."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if _is_zero(Z2):
        return p
    if _is_zero(Z1):
        return q
    Z1Z1, Z2Z2 = pair_sqr(Z1), pair_sqr(Z2)
    U1 = pair_mul(X1, Z2Z2)
    S1 = pair_mul(pair_mul(Y1, Z2), Z2Z2)
    H = _fsub(pair_mul(X2, Z1Z1), U1)
    r = _fsub(pair_mul(pair_mul(Y2, Z1), Z1Z1), S1)
    if _is_zero(H) and _is_zero(r):
        return pair_dbl_model(p)
    a = pair_mul(pair_mul(Z1, Z2), H)
    Z3 = _fadd(a, a)                  # 2 Z1 Z2 H = ((Z1 + Z2)^2 - ...) H
    I = pair_sqr(_fadd(H, H))
    J = pair_mul(H, I)
    V = pair_mul(U1, I)
    r2 = _fadd(r, r)
    X3 = _fsub(_fsub(pair_sqr(r2), J), _fadd(V, V))
    S1J = pair_mul(S1, J)
    Y3 = _fsub(pair_mul(r2, _fsub(V, X3)), _fadd(S1J, S1J))
    return X3, Y3, Z3


def _mont2(v: Fq2):
    return v.c0.n * R % P, v.c1.n * R % P


def _jac(pt, z, rnd=None):
    """Golden G2 point -> Jacobian (X, Y, Z) of Montgomery Fq2 values with
    Z = z (x z^2, y z^3, z); infinity: Z = 0 and garbage X, Y."""
    if pt.is_zero():
        r = rnd or random.Random(0)
        return ((r.randrange(P), r.randrange(P)),
                (r.randrange(P), r.randrange(P)), (0, 0))
    return (_mont2(pt.x * z * z), _mont2(pt.y * z * z * z), _mont2(z))


def _rand_z(r):
    return Fq2.of_ints(r.randrange(1, P), r.randrange(P))


def _point_case(name: str):
    """(P, Q, golden P, golden Q) of one case, Jacobian Montgomery Fq2."""
    r = random.Random(sum(map(ord, name)))
    gen = G2.generator()
    a = gen * r.randrange(1, 1 << 64)
    b = gen * r.randrange(1, 1 << 64)
    one = Fq2.of_ints(1, 0)
    za, zb = _rand_z(r), _rand_z(r)
    ga, gb = {"random": (a, b), "z_one": (a, b), "p_equals_q": (a, a),
              "p_equals_q_same_words": (a, a), "p_equals_minus_q": (a, -a),
              "p_infinity": (G2.zero(), b), "q_infinity": (a, G2.zero()),
              "both_infinity": (G2.zero(), G2.zero()),
              "sum_is_p_plus_p_minus_q": (a + a, -a)}[name]
    if name == "z_one":
        za = zb = one
    if name == "p_equals_q_same_words":
        zb = za
    return _jac(ga, za, r), _jac(gb, zb, r), ga, gb


def _pack_points(pts):
    """[(X, Y, Z)] of Fq2 values -> (X, Y, Z) coordinates (2, 12, N)."""
    return tuple(_coords([pt[i] for pt in pts], "cpu") for i in range(3))


def _unpack_points(P3):
    cols = [_values(c) for c in P3]
    return [tuple(c[e] for c in cols) for e in range(P3[0].shape[2])]


ADD_CASES = ("random", "z_one", "p_equals_q", "p_equals_q_same_words",
             "p_equals_minus_q", "p_infinity", "q_infinity", "both_infinity",
             "sum_is_p_plus_p_minus_q")


@pytest.mark.parametrize("name", ADD_CASES)
def test_pair_add_equals_the_one_thread_formula(name):
    """The pair add's words equal the one-thread add-2007-bl's
    (`kernels._add` on G2, whose words the one-thread kernel gave), both
    ways round; its points equal the golden sums."""
    p, q, gp, gq = _point_case(name)
    o = K._OPS["g2"]
    for x, y, gx, gy in ((p, q, gp, gq), (q, p, gq, gp)):
        got = pair_add_model(x, y)
        want = _unpack_points(K._add(_pack_points([x]), _pack_points([y]),
                                     o))[0]
        assert got == want
        assert C.unpack_g2(_pack_points([got]))[0] == gx + gy


DBL_CASES = ("random", "z_one", "infinity", "minus_p")


@pytest.mark.parametrize("name", DBL_CASES)
def test_pair_dbl_equals_the_one_thread_formula(name):
    """The pair doubling's words equal the one-thread dbl-2009-l's
    (`kernels._dbl_formula` on G2), infinity included (the formula runs
    on it: Z3 = 2 Y Z = 0); its points equal the golden doublings."""
    r = random.Random(len(name))
    gen = G2.generator()
    a = gen * r.randrange(1, 1 << 64)
    g = {"random": a, "z_one": a, "infinity": G2.zero(), "minus_p": -a}[name]
    pt = _jac(g, Fq2.of_ints(1, 0) if name == "z_one" else _rand_z(r), r)
    got = pair_dbl_model(pt)
    want = _unpack_points(K._dbl_formula(_pack_points([pt]), K._OPS["g2"]))[0]
    assert got == want
    assert C.unpack_g2(_pack_points([got]))[0] == g.double()


@pytest.mark.parametrize("seed", range(3))
def test_pair_add_chain_random(seed):
    """A chain of adds as a K7 lane runs them (acc = acc + point), over
    random points with Z != 1, repeats and negations: every step's words
    equal the one-thread formula's."""
    r = random.Random(seed)
    gen = G2.generator()
    base = [gen * r.randrange(1, 1 << 64) for _ in range(4)]
    seq = [base[r.randrange(4)] * (1 if r.random() < 0.7 else -1)
           for _ in range(8)] + [G2.zero()]
    o = K._OPS["g2"]
    acc, gacc = _jac(seq[0], _rand_z(r), r), seq[0]
    for g in seq[1:]:
        pt = _jac(g, _rand_z(r), r)
        got = pair_add_model(acc, pt)
        want = _unpack_points(K._add(_pack_points([acc]), _pack_points([pt]),
                                     o))[0]
        assert got == want
        acc, gacc = got, gacc + g
        assert C.unpack_g2(_pack_points([acc]))[0] == gacc
