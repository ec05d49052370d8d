"""Optimal ate pairing on BLS12-381 (golden implementation).

The port's own copy of `zukelang_tpu/golden/pairing.py`.  The OCaml
reference reaches pairing through blst (`Pairing.pairing`, used in
src/pinocchio/pinocchio.ml:269 and src/groth16/groth16.ml:168).  This is the from-scratch
equivalent: Miller loop over the untwisted Q in E(Fq12) plus final
exponentiation.  Verify-side only (<= 9 pairings per proof), so clarity wins
over micro-optimization here.
"""

from __future__ import annotations

from .. import params
from .field import Fq6, Fq12, Fq2, Fq
from .curve import G1, G2, GT

# w and its inverse powers for the untwist map psi: E'(Fq2) -> E(Fq12),
# psi(x, y) = (x / w^2, y / w^3), valid because w^6 = xi and E' is the
# M-type twist y^2 = x^3 + 4*xi.
_W = Fq12(Fq6.zero(), Fq6.one())                 # w
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()

# Hard part of the final exponentiation.  Like blst/arkworks we raise to
# 3*(p^4-p^2+1)/r, using the BLS12 decomposition
#   (z-1)^2 * (z+p) * (z^2+p^2-1) + 3  ==  3*(p^4-p^2+1)/r
# (verified below), which needs only four ~64-bit exponentiations by the BLS
# parameter z instead of one 1270-bit exponentiation.
_Z = -params.BLS_X
assert ((_Z - 1) ** 2 * (_Z + params.P) * (_Z * _Z + params.P ** 2 - 1) + 3
        == 3 * (params.P ** 4 - params.P ** 2 + 1) // params.R)


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def _untwist(q: G2):
    x = _fq2_to_fq12(q.x) * _W2_INV
    y = _fq2_to_fq12(q.y) * _W3_INV
    return x, y


def _fq_to_fq12(a: Fq) -> Fq12:
    return _fq2_to_fq12(Fq2(a, Fq(0)))


def _line(ax, ay, bx, by, px, py) -> Fq12:
    """Evaluate the line through A, B in E(Fq12) at P (all Fq12 scalars).

    Scale factors in proper subfields are annihilated by the final
    exponentiation, so the simple slope form is sufficient.
    """
    if ax == bx and ay == by:
        # tangent
        three = Fq12.one() + Fq12.one() + Fq12.one()
        two = Fq12.one() + Fq12.one()
        m = three * ax * ax / (two * ay)
        return m * (px - ax) - (py - ay)
    if ax == bx:
        # vertical
        return px - ax
    m = (by - ay) / (bx - ax)
    return m * (px - ax) - (py - ay)


def miller_loop(p: G1, q: G2) -> Fq12:
    if p.is_zero() or q.is_zero():
        return Fq12.one()
    qx, qy = _untwist(q)
    px, py = _fq_to_fq12(p.x), _fq_to_fq12(p.y)

    f = Fq12.one()
    tx, ty = qx, qy
    bits = bin(params.BLS_X)[3:]  # skip MSB
    for bit in bits:
        f = f.square() * _line(tx, ty, tx, ty, px, py)
        # T = 2T in E(Fq12)
        three = Fq12.one() + Fq12.one() + Fq12.one()
        two = Fq12.one() + Fq12.one()
        m = three * tx * tx / (two * ty)
        nx = m * m - tx - tx
        ny = m * (tx - nx) - ty
        tx, ty = nx, ny
        if bit == "1":
            f = f * _line(tx, ty, qx, qy, px, py)
            if tx == qx:
                # only possible as T == +-Q; T + (-T) -> infinity never
                # happens inside the BLS loop for valid inputs.
                raise ArithmeticError("unexpected doubling case in Miller loop")
            m = (qy - ty) / (qx - tx)
            nx = m * m - tx - qx
            ny = m * (tx - nx) - ty
            tx, ty = nx, ny
    if params.BLS_X_IS_NEG:
        f = f.conj()  # f_{-x} ~ conj(f_x) up to final exp
    return f


def _cyc_pow(f: Fq12, e: int) -> Fq12:
    """Exponentiation for elements of the cyclotomic subgroup, where the
    inverse is free (conjugation)."""
    if e < 0:
        return _cyc_pow(f, -e).conj()
    result, base = Fq12.one(), f
    while e > 0:
        if e & 1:
            result = result * base
        base = base.square()
        e >>= 1
    return result


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((p^6-1)(p^2+1)); afterwards f lies in the cyclotomic
    # subgroup (inverse == conjugate).
    f1 = f.conj() * f.inv()
    f = f1.frobenius(2) * f1
    # hard part: f^((z-1)^2 (z+p) (z^2+p^2-1) + 3)
    z = _Z
    t0 = _cyc_pow(f, z - 1)
    t0 = _cyc_pow(t0, z - 1)                      # f^((z-1)^2)
    t1 = _cyc_pow(t0, z) * t0.frobenius(1)        # ^(z+p)
    t2 = _cyc_pow(_cyc_pow(t1, z), z) * t1.frobenius(2) * t1.conj()  # ^(z^2+p^2-1)
    return t2 * f.square() * f                    # * f^3


def pairing(p: G1, q: G2) -> GT:
    """e(P, Q) — bilinear, non-degenerate on G1 x G2."""
    return GT(final_exponentiation(miller_loop(p, q)))


def multi_pairing(pairs) -> GT:
    """Product of pairings with a single shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return GT(final_exponentiation(f))
