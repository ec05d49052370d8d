"""Dense polynomials over a field — golden coefficient-form implementation.

Mirrors `Polynomial.Make(F)` (src/lib/zk/polynomial.ml): coefficient lists
(low degree first), O(n^2) multiply / Lagrange interpolation / long division.
The port's own copy of `zukelang_tpu/core/poly.py`.  This is the semantic
reference; the device path (`ops/ntt.py`, `engine/torch_engine.py`)
performs the same operations in evaluation form over radix-2
root-of-unity domains.
"""

from __future__ import annotations

from typing import List, Sequence

from ..golden.field import Fr


def normalize(p: List[Fr]) -> List[Fr]:
    i = len(p)
    while i > 0 and p[i - 1].is_zero():
        i -= 1
    return p[:i]


def zero() -> List[Fr]:
    return []


def one() -> List[Fr]:
    return [Fr(1)]


def apply(p: Sequence[Fr], x: Fr) -> Fr:
    acc = Fr(0)
    for c in reversed(p):
        acc = acc * x + c
    return acc


def add(p1, p2) -> List[Fr]:
    n = max(len(p1), len(p2))
    out = []
    for i in range(n):
        a = p1[i] if i < len(p1) else Fr(0)
        b = p2[i] if i < len(p2) else Fr(0)
        out.append(a + b)
    return normalize(out)


def neg(p) -> List[Fr]:
    return [-c for c in p]


def sub(p1, p2) -> List[Fr]:
    return add(p1, neg(p2))


def mul_scalar(s: Fr, p) -> List[Fr]:
    if s.is_zero():
        return []
    return [s * c for c in p]


def mul(p1, p2) -> List[Fr]:
    if not p1 or not p2:
        return []
    out = [Fr(0)] * (len(p1) + len(p2) - 1)
    for i, a in enumerate(p1):
        if a.is_zero():
            continue
        for j, b in enumerate(p2):
            out[i + j] = out[i + j] + a * b
    return normalize(out)


def div_rem(p1, p2):
    """Long division (polynomial.ml:142-169): returns (quotient, remainder)."""
    p1, p2 = normalize(list(p1)), normalize(list(p2))
    if not p2:
        raise ZeroDivisionError("polynomial division by zero")
    rem = list(p1)
    dq = len(p1) - len(p2)
    if dq < 0:
        return [], p1
    q = [Fr(0)] * (dq + 1)
    inv_lead = p2[-1].inv()
    for k in range(dq, -1, -1):
        c = rem[k + len(p2) - 1] * inv_lead
        q[k] = c
        if not c.is_zero():
            for j, b in enumerate(p2):
                rem[k + j] = rem[k + j] - c * b
    return normalize(q), normalize(rem)


def lagrange_basis(xs: Sequence[Fr]) -> List[List[Fr]]:
    """l_j(x) for each x_j (polynomial.ml:212-226)."""
    out = []
    for j, xj in enumerate(xs):
        p = one()
        for i, xi in enumerate(xs):
            if i == j:
                continue
            d = (xj - xi).inv()
            p = mul(p, [(-xi) * d, d])  # (x - xi)/(xj - xi)
        out.append(p)
    return out


def interpolate(points) -> List[Fr]:
    """Lagrange interpolation through (x, y) pairs (polynomial.ml:228-230)."""
    xs = [x for x, _ in points]
    basis = lagrange_basis(xs)
    acc = zero()
    for (_, y), l in zip(points, basis):
        acc = add(acc, mul_scalar(y, l))
    return acc


def z(xs: Sequence[Fr]) -> List[Fr]:
    """Vanishing polynomial prod (x - xi) (polynomial.ml:248-251)."""
    p = one()
    for x in xs:
        p = mul(p, [-x, Fr(1)])
    return p


def degree(p) -> int:
    n = len(normalize(list(p)))
    return 0 if n == 0 else n - 1


def is_zero(p) -> bool:
    return not normalize(list(p))


def equal(p1, p2) -> bool:
    return normalize(list(p1)) == normalize(list(p2))
