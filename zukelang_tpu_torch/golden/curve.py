"""Golden G1/G2/GT groups with ZCash-spec serialization.

The port's own copy of `zukelang_tpu/golden/curve.py`, the role of the
blst-backed `Curve.Bls12_381` module in the OCaml reference
(src/lib/zk/curve.ml:74-221): group law, scalar mult, linear folds
(`dot`, `powers`, `apply_powers`) and compressed-point encodings.  The
port uses it for host points: unpacked device results, proof assembly,
verifying keys.

Points are affine (x, y) with None for the identity; field coordinates are
golden Fq / Fq2 elements.  A scalar is anything with a canonical int `.n`
(this package's Fr or the JAX package's) or an int.  The device path is
`ops/` (limb tensors and the CUDA kernels).
"""

from __future__ import annotations

from .. import params
from .field import Fq, Fq2, Fq12, Fr


def _scalar(k) -> int:
    """Fr of either package (a canonical int `.n`) or int -> int mod r."""
    return (k.n if hasattr(k, "n") else int(k)) % params.R


def _jac_double(X, Y, Z):
    """Jacobian doubling (a=0 curves); infinity iff Z == 0."""
    if Y.is_zero() or Z.is_zero():
        zero = X - X
        return X, Y, zero
    A = X * X
    B = Y * Y
    C = B * B
    t = X + B
    D = t * t - A - C
    D = D + D
    E = A + A + A
    F = E * E
    X3 = F - D - D
    c8 = C + C
    c8 = c8 + c8
    c8 = c8 + c8
    Y3 = E * (D - X3) - c8
    Z3 = (Y * Z) + (Y * Z)
    return X3, Y3, Z3


def _jac_add_affine(X, Y, Z, x2, y2):
    """Mixed Jacobian + affine addition; the affine point must not be
    infinity."""
    if Z.is_zero():
        one = y2 / y2
        return x2, y2, one
    Z2 = Z * Z
    U2 = x2 * Z2
    S2 = y2 * Z2 * Z
    H = U2 - X
    rr = S2 - Y
    if H.is_zero():
        if rr.is_zero():
            return _jac_double(X, Y, Z)
        zero = X - X
        return X, Y, zero  # P + (-P) = infinity
    H2 = H * H
    H3 = H2 * H
    XH2 = X * H2
    X3 = rr * rr - H3 - XH2 - XH2
    Y3 = rr * (XH2 - X3) - Y * H3
    Z3 = Z * H
    return X3, Y3, Z3


class _CurvePoint:
    """Shared affine short-Weierstrass group law: y^2 = x^3 + b."""

    __slots__ = ("x", "y")
    b = None        # curve constant, set by subclass
    field = None    # coordinate field class

    def __init__(self, x, y):
        self.x, self.y = x, y

    # -- constructors ------------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(None, None)

    @classmethod
    def generator(cls):
        raise NotImplementedError

    def is_zero(self):
        return self.x is None

    def is_on_curve(self):
        if self.is_zero():
            return True
        return self.y * self.y == self.x * self.x * self.x + self.b

    # -- group law ---------------------------------------------------------
    def __add__(self, o):
        if self.is_zero():
            return o
        if o.is_zero():
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return type(self).zero()
        m = (o.y - self.y) / (o.x - self.x)
        x3 = m * m - self.x - o.x
        y3 = m * (self.x - x3) - self.y
        return type(self)(x3, y3)

    def double(self):
        if self.is_zero() or self.y.is_zero():
            return type(self).zero()
        three = self.field.one() + self.field.one() + self.field.one()
        two = self.field.one() + self.field.one()
        m = (three * self.x * self.x) / (two * self.y)
        x3 = m * m - self.x - self.x
        y3 = m * (self.x - x3) - self.y
        return type(self)(x3, y3)

    def __neg__(self):
        if self.is_zero():
            return self
        return type(self)(self.x, -self.y)

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k):
        """Scalar multiplication by Fr (or int) — Jacobian double-and-add
        with a single final inversion."""
        e = _scalar(k)
        if e == 0 or self.is_zero():
            return type(self).zero()
        x2, y2 = self.x, self.y
        X, Y, Z = x2, y2, self.field.one()  # accumulator starts at P (MSB)
        for bit in bin(e)[3:]:
            X, Y, Z = _jac_double(X, Y, Z)
            if bit == "1":
                X, Y, Z = _jac_add_affine(X, Y, Z, x2, y2)
        if Z.is_zero():
            return type(self).zero()
        zinv = Z.inv()
        zinv2 = zinv * zinv
        return type(self)(X * zinv2, Y * zinv2 * zinv)

    def __eq__(self, o):
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((type(self).__name__, self.x, self.y))

    # -- reference-style helpers (curve.ml:22-50) --------------------------
    @classmethod
    def of_Fr(cls, fr: Fr):
        """g * fr — the exponent embedding used throughout the protocols."""
        return cls.generator() * fr

    @classmethod
    def sum(cls, points):
        acc = cls.zero()
        for pt in points:
            acc = acc + pt
        return acc

    @classmethod
    def dot(cls, points, scalars):
        """Sigma_k points[k] * scalars[k] — the reference's naive MSM
        (curve.ml:94-103).  The device path replaces this with Pippenger."""
        if len(points) != len(scalars):
            raise ValueError("dot: length mismatch")
        acc = cls.zero()
        for pt, s in zip(points, scalars):
            acc = acc + pt * s
        return acc

    @classmethod
    def powers(cls, d: int, s: Fr):
        """[g^(s^i) for i in 0..d]  (curve.ml:106-109)."""
        out, acc = [], Fr(1)
        for _ in range(d + 1):
            out.append(cls.of_Fr(acc))
            acc = acc * s
        return out

    @classmethod
    def apply_powers(cls, coeffs, xis):
        """Sigma_i coeffs[i] * xis[i] — polynomial evaluation in the exponent
        (curve.ml:112-118)."""
        if len(coeffs) > len(xis):
            raise ValueError("apply_powers: not enough powers")
        acc = cls.zero()
        for c, x in zip(coeffs, xis):
            acc = acc + x * c
        return acc


class G1(_CurvePoint):
    __slots__ = ()
    b = Fq(params.B_G1)
    field = Fq

    @classmethod
    def generator(cls):
        return cls(Fq(params.G1_GEN_X), Fq(params.G1_GEN_Y))

    # -- ZCash compressed serialization (48 bytes) -------------------------
    def to_compressed_bytes(self) -> bytes:
        if self.is_zero():
            out = bytearray(48)
            out[0] = 0xC0
            return bytes(out)
        out = bytearray(self.x.n.to_bytes(48, "big"))
        out[0] |= 0x80
        if self.y.n > (params.P - 1) // 2:
            out[0] |= 0x20
        return bytes(out)

    @classmethod
    def of_compressed_bytes(cls, data: bytes) -> "G1":
        if len(data) != 48:
            raise ValueError("G1 compressed encoding must be 48 bytes")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 encoding not supported here")
        if flags & 0x40:
            return cls.zero()
        x = Fq(int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big"))
        y = (x * x * x + cls.b).sqrt()
        if y is None:
            raise ValueError("invalid G1 x coordinate")
        y_is_big = y.n > (params.P - 1) // 2
        if bool(flags & 0x20) != y_is_big:
            y = -y
        return cls(x, y)


class G2(_CurvePoint):
    __slots__ = ()
    b = Fq2.of_ints(*params.B_G2)
    field = Fq2

    @classmethod
    def generator(cls):
        return cls(Fq2.of_ints(*params.G2_GEN_X), Fq2.of_ints(*params.G2_GEN_Y))

    # -- ZCash compressed serialization (96 bytes: x.c1 || x.c0) -----------
    def to_compressed_bytes(self) -> bytes:
        if self.is_zero():
            out = bytearray(96)
            out[0] = 0xC0
            return bytes(out)
        out = bytearray(self.x.c1.n.to_bytes(48, "big") + self.x.c0.n.to_bytes(48, "big"))
        out[0] |= 0x80
        if _fq2_is_lex_big(self.y):
            out[0] |= 0x20
        return bytes(out)

    @classmethod
    def of_compressed_bytes(cls, data: bytes) -> "G2":
        if len(data) != 96:
            raise ValueError("G2 compressed encoding must be 96 bytes")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G2 encoding not supported here")
        if flags & 0x40:
            return cls.zero()
        c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        c0 = int.from_bytes(data[48:96], "big")
        x = Fq2.of_ints(c0, c1)
        y = (x * x * x + cls.b).sqrt()
        if y is None:
            raise ValueError("invalid G2 x coordinate")
        if bool(flags & 0x20) != _fq2_is_lex_big(y):
            y = -y
        return cls(x, y)


def _fq2_is_lex_big(y: Fq2) -> bool:
    """ZCash sign convention for Fq2: compare (c1, c0) lexicographically."""
    if y.c1.n != 0:
        return y.c1.n > (params.P - 1) // 2
    return y.c0.n > (params.P - 1) // 2


class GT:
    """Target group, written additively to mirror the reference's `Curve.G`
    signature (GT.add is Fq12 multiplication; curve.ml:213-220)."""

    __slots__ = ("v",)

    def __init__(self, v: Fq12):
        self.v = v

    @classmethod
    def zero(cls):
        return cls(Fq12.one())

    @classmethod
    def generator(cls):
        from .pairing import pairing
        return pairing(G1.generator(), G2.generator())

    def __add__(self, o):
        return GT(self.v * o.v)

    def __neg__(self):
        # GT lives in the cyclotomic subgroup: inverse == conjugation.
        return GT(self.v.conj())

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k):
        return GT(self.v ** _scalar(k))

    def __eq__(self, o):
        return self.v == o.v

    def __hash__(self):
        return hash(("GT", self.v))

    @classmethod
    def sum(cls, xs):
        acc = cls.zero()
        for x in xs:
            acc = acc + x
        return acc

    def to_bytes(self) -> bytes:
        """Uncompressed 576-byte encoding: 12 Fq coefficients, big-endian,
        in tower order (c0.c0.c0, c0.c0.c1, c0.c1.c0, ...)."""
        out = b""
        for fq6 in (self.v.c0, self.v.c1):
            for fq2 in (fq6.c0, fq6.c1, fq6.c2):
                out += fq2.c0.n.to_bytes(48, "big")
                out += fq2.c1.n.to_bytes(48, "big")
        return out

    @classmethod
    def of_bytes(cls, data: bytes) -> "GT":
        if len(data) != 576:
            raise ValueError("GT encoding must be 576 bytes")
        ints = [int.from_bytes(data[i * 48:(i + 1) * 48], "big") for i in range(12)]
        from .field import Fq6
        fq2s = [Fq2.of_ints(ints[i], ints[i + 1]) for i in range(0, 12, 2)]
        return cls(Fq12(Fq6(*fq2s[0:3]), Fq6(*fq2s[3:6])))
