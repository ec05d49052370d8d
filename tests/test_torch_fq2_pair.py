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
"""

import random

import pytest
import torch

from zukelang_tpu_torch.ops import kernels as K

from zukelang_tpu_torch.golden.field import Fq2
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
