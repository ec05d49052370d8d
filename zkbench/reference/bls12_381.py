"""BLS12-381 in plain Python integers: the fields, the two groups of the
pairing-friendly curve, and fixed-base scalar multiplication of the
standard generators.

This is the benchmark's own frozen copy of the curve (constants from the
IETF pairing-friendly-curves draft and the Zcash specification).  It
imports nothing of the program under test.

  Fq   integers mod P;  Fq2 = Fq[u] / (u^2 + 1), elements (c0, c1)
  G1   y^2 = x^3 + 4 over Fq;  G2   y^2 = x^3 + 4 (u + 1) over Fq2
  Fr   integers mod R, the order of both groups

Points are affine tuples (x, y), or None for the point at infinity;
Jacobian triples (X, Y, Z) appear only inside this module.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)


class Fq:
    """Operations on integers mod P."""
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def small(a, k):
        return a * k % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)


class Fq2:
    """Operations on pairs (c0, c1) = c0 + c1 u, u^2 = -1."""
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P,
                ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def small(a, k):
        return (a[0] * k % P, a[1] * k % P)

    @staticmethod
    def inv(a):
        t = pow(a[0] * a[0] + a[1] * a[1], -1, P)
        return (a[0] * t % P, -a[1] * t % P)


def _double(F, p):
    """dbl-2009-l on Jacobian (X, Y, Z) of y^2 = x^3 + b."""
    X, Y, Z = p
    if Z == F.zero or Y == F.zero:
        return (F.one, F.one, F.zero)
    A = F.mul(X, X)
    B = F.mul(Y, Y)
    C = F.mul(B, B)
    D = F.small(F.sub(F.sub(F.mul(F.add(X, B), F.add(X, B)), A), C), 2)
    E = F.small(A, 3)
    Fv = F.mul(E, E)
    X3 = F.sub(Fv, F.small(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.small(C, 8))
    Z3 = F.small(F.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _add_affine(F, p, q):
    """Jacobian p + affine q (q not None), the equal and opposite cases
    included."""
    X1, Y1, Z1 = p
    if Z1 == F.zero:
        return (q[0], q[1], F.one)
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(q[0], Z1Z1)
    S2 = F.mul(F.mul(q[1], Z1), Z1Z1)
    H = F.sub(U2, X1)
    rr = F.sub(S2, Y1)
    if H == F.zero:
        if rr == F.zero:
            return _double(F, p)
        return (F.one, F.one, F.zero)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.mul(rr, rr), HHH), F.small(V, 2))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul(Y1, HHH))
    Z3 = F.mul(Z1, H)
    return (X3, Y3, Z3)


def _to_affine(F, p):
    X, Y, Z = p
    if Z == F.zero:
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi)))


def add(F, p: Optional[tuple], q: Optional[tuple]) -> Optional[tuple]:
    """Affine p + q."""
    if q is None:
        return p
    if p is None:
        return q
    return _to_affine(F, _add_affine(F, (p[0], p[1], F.one), q))


def on_curve(F, b, p) -> bool:
    if p is None:
        return True
    x, y = p
    return F.mul(y, y) == F.add(F.mul(F.mul(x, x), x), b)


class FixedBase:
    """k * g for one base g and any k mod R: 32 windows of 8 bits, each a
    table of d * 2^(8 j) * g (d = 1 .. 255) in affine form, so a product
    is at most 32 mixed additions."""

    WINDOW = 8

    def __init__(self, F, g):
        self.F = F
        w = self.WINDOW
        self.tables: List[List[Tuple]] = []
        base = g
        for _j in range((256 + w - 1) // w):
            row = [None, base]
            acc = (base[0], base[1], F.one)
            for _d in range(2, 1 << w):
                acc = _add_affine(F, acc, base)
                row.append(acc)
            row[2:] = [_to_affine(F, p) for p in row[2:]]
            self.tables.append(row)
            nxt = (base[0], base[1], F.one)
            for _ in range(w):
                nxt = _double(F, nxt)
            base = _to_affine(F, nxt)

    def mul(self, k: int) -> Optional[tuple]:
        F, w, mask = self.F, self.WINDOW, (1 << self.WINDOW) - 1
        k %= R
        acc = (F.one, F.one, F.zero)
        j = 0
        while k:
            d = k & mask
            if d:
                acc = _add_affine(F, acc, self.tables[j][d])
            k >>= w
            j += 1
        return _to_affine(F, acc)


def g1_base() -> FixedBase:
    return FixedBase(Fq, (G1_X, G1_Y))


def g2_base() -> FixedBase:
    return FixedBase(Fq2, (G2_X, G2_Y))
