"""Golden (pure-Python big-int) field arithmetic: Fr, Fq and the Fq2/Fq6/Fq12 tower.

The port's own copy of `zukelang_tpu/golden/field.py`: the host-side
oracle for scalars and point coordinates (the role blst's C arithmetic
plays for the OCaml reference, src/lib/zk/curve.ml:74-221).  Its classes
are not the JAX package's: compare values across the two packages by
their ints or encodings.

Tower construction (standard BLS12-381):
    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from ..params import P, R


class PrimeFieldElement:
    """Element of a prime field; subclasses fix the modulus.

    Mirrors the reference's `Field.S` signature (src/lib/zk/field.ml:3-39):
    zero/one, (+,-,*,/), of_int, equality.  Values are canonical ints in [0, p).
    """

    __slots__ = ("n",)
    p: int = 0  # overridden

    def __init__(self, n: int):
        self.n = n % self.p

    # -- constructors ------------------------------------------------------
    @classmethod
    def of_int(cls, n: int):
        return cls(n)

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.n + o.n)

    def __sub__(self, o):
        return type(self)(self.n - o.n)

    def __neg__(self):
        return type(self)(-self.n)

    def __mul__(self, o):
        return type(self)(self.n * o.n)

    def inv(self):
        if self.n == 0:
            raise ZeroDivisionError("field inverse of zero")
        return type(self)(pow(self.n, -1, self.p))

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        return type(self)(pow(self.n, e % (self.p - 1) if e >= 0 else e, self.p))

    # -- comparisons / hashing --------------------------------------------
    def __eq__(self, o):
        return isinstance(o, type(self)) and self.n == o.n

    def __hash__(self):
        return hash((type(self).__name__, self.n))

    def __repr__(self):
        # Reference prints values close to the modulus as negatives
        # (curve.ml:124-131); match that for debuggability.
        if self.n > self.p - 1_000_000:
            return str(self.n - self.p)
        return str(self.n)

    def is_zero(self):
        return self.n == 0

    def sqrt(self):
        """Square root for p = 3 mod 4; returns None if not a QR."""
        assert self.p % 4 == 3
        c = pow(self.n, (self.p + 1) // 4, self.p)
        if c * c % self.p != self.n:
            return None
        return type(self)(c)


class Fr(PrimeFieldElement):
    """BLS12-381 scalar field (order of G1/G2/GT)."""
    __slots__ = ()
    p = R


class Fq(PrimeFieldElement):
    """BLS12-381 base field."""
    __slots__ = ()
    p = P


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1)
# ---------------------------------------------------------------------------

class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0, self.c1 = c0, c1

    @classmethod
    def of_ints(cls, c0: int, c1: int):
        return cls(Fq(c0), Fq(c1))

    @classmethod
    def zero(cls):
        return cls(Fq(0), Fq(0))

    @classmethod
    def one(cls):
        return cls(Fq(1), Fq(0))

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, Fq):
            return Fq2(self.c0 * o, self.c1 * o)
        # Karatsuba: 3 Fq muls
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        v0 = a * c
        v1 = b * d
        t = (a + b) * (c + d)
        return Fq2(v0 - v1, t - v0 - v1)

    def square(self):
        # complex squaring: 2 Fq muls
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), (m := a * b) + m)

    def conj(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        norm = self.c0 * self.c0 + self.c1 * self.c1
        ninv = norm.inv()
        return Fq2(self.c0 * ninv, -(self.c1 * ninv))

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        result, base = Fq2.one(), self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq2", self.c0.n, self.c1.n))

    def __repr__(self):
        return f"Fq2({self.c0!r}, {self.c1!r})"

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def sqrt(self):
        """Square root in Fq2 via the complex method (valid as p = 3 mod 4).

        Needed for G2 point decompression (ZCash serialization spec, mirrored
        from blst's of_compressed_bytes used at curve.ml:199-210).
        """
        if self.is_zero():
            return Fq2.zero()
        a, b = self.c0, self.c1
        if b.is_zero():
            r = a.sqrt()
            if r is not None:
                return Fq2(r, Fq(0))
            # sqrt(a) = sqrt(-a) * u since u^2 = -1
            r = (-a).sqrt()
            if r is None:
                return None
            return Fq2(Fq(0), r)
        n = (a * a + b * b).sqrt()
        if n is None:
            return None
        for s in (n, -n):
            half = (a + s) * Fq(2).inv()
            r0 = half.sqrt()
            if r0 is not None and not r0.is_zero():
                r1 = b * (r0 + r0).inv()
                cand = Fq2(r0, r1)
                if cand * cand == self:
                    return cand
        return None


XI = Fq2.of_ints(1, 1)  # the non-residue u+1 defining Fq6


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @classmethod
    def one(cls):
        return cls(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        # Karatsuba-style interpolation: 6 Fq2 muls
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = v0 + ((a1 + a2) * (b1 + b2) - v1 - v2) * XI
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + v2 * XI
        c2 = (a0 + a2) * (b0 + b2) - v0 + v1 - v2
        return Fq6(c0, c1, c2)

    def mul_by_v(self):
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * a0 - a1 * a2 * XI
        t1 = a2 * a2 * XI - a0 * a1
        t2 = a1 * a1 - a0 * a2
        d = a0 * t0 + (a2 * t1 + a1 * t2) * XI
        dinv = d.inv()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash(("Fq6", self.c0, self.c1, self.c2))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @classmethod
    def zero(cls):
        return cls(Fq6.zero(), Fq6.zero())

    @classmethod
    def one(cls):
        return cls(Fq6.one(), Fq6.zero())

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        # Karatsuba: 3 Fq6 muls
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        v0 = a0 * b0
        v1 = a1 * b1
        t = (a0 + a1) * (b0 + b1)
        return Fq12(v0 + v1.mul_by_v(), t - v0 - v1)

    def square(self):
        # complex squaring: 2 Fq6 muls
        a0, a1 = self.c0, self.c1
        m = a0 * a1
        t = (a0 + a1) * (a0 + a1.mul_by_v())
        return Fq12(t - m - m.mul_by_v(), m + m)

    def conj(self):
        """p^6-Frobenius: conjugation over Fq6 (negates the w coefficient)."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        d = a0 * a0 - (a1 * a1).mul_by_v()
        dinv = d.inv()
        return Fq12(a0 * dinv, -(a1 * dinv))

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        result, base = Fq12.one(), self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq12", self.c0, self.c1))

    def is_one(self):
        return self == Fq12.one()

    # -- Frobenius endomorphism -------------------------------------------
    # Basis over Fq2: {1, v, v^2} for each Fq6 coefficient, with the w part.
    # a^p conjugates every Fq2 coefficient and scales basis monomials by
    # powers of xi^((p-1)/6), precomputed below.

    def frobenius(self, power: int = 1):
        f = self
        for _ in range(power % 12):
            f = _frobenius_once(f)
        return f

    def coeffs(self):
        """The 6 Fq2 coefficients in basis {1, v, v^2, w, vw, v^2 w}."""
        return [self.c0.c0, self.c0.c1, self.c0.c2,
                self.c1.c0, self.c1.c1, self.c1.c2]

    @classmethod
    def from_coeffs(cls, cs):
        return cls(Fq6(cs[0], cs[1], cs[2]), Fq6(cs[3], cs[4], cs[5]))


# gamma_i = xi^(i*(p-1)/6): scale factors for the p-Frobenius on the basis
# monomials v = w^2, v^2 = w^4, w, vw = w^3, v^2 w = w^5.
_GAMMA = [XI ** ((i * (P - 1)) // 6) for i in range(6)]


def _frobenius_once(f: Fq12) -> Fq12:
    cs = [c.conj() for c in f.coeffs()]
    # monomial exponents of w for the basis: 1=w^0, v=w^2, v^2=w^4, w=w^1, vw=w^3, v^2w=w^5
    w_exp = [0, 2, 4, 1, 3, 5]
    out = [cs[i] * _GAMMA[w_exp[i]] for i in range(6)]
    return Fq12.from_coeffs(out)
