"""Batched elliptic-curve arithmetic on limb tensors (G1 over Fq, G2 over Fq2).

Counterpart of `zukelang_tpu/ops/curve_jax.py`.  Jacobian coordinates,
branch-free: infinity is Z == 0.  A point batch is a tuple (X, Y, Z) of
Montgomery-form coordinates, `(12, N)` for G1 and `(2, 12, N)` for G2; an
affine batch is (X, Y) with (0, 0) marking infinity.

`point_add`, `point_double` and `point_double_n` (a chain of doublings in
one launch) are kernel K2, `point_madd` is K3 with a K2 fix-up
(`ops.kernels`; the paths take K3's chain, `kernels.point_madd_chain`,
and `point_madd` stays as the reference the tests hold the chain to).
The other functions compose field operations, whose products are K1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import params
from ..golden.curve import G1, G2
from ..golden.field import Fq, Fq2
from ..params import FQ
from . import field as F
from . import kernels as K

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
AffinePoint = Tuple[torch.Tensor, torch.Tensor]

# Coordinate-field vtables whose products go through K1.
OPS = {g: K.FieldOps(g, F.mont_mul) for g in ("g1", "g2")}


def point_add(p: Point, q: Point) -> Point:
    return K.point_add(p, q)


def point_double(p: Point) -> Point:
    return K.point_double(p)


def point_double_n(p: Point, counts) -> Point:
    """Point i doubled counts[i] times (an (N,) int32 tensor or one int)."""
    return K.point_double_n(p, counts)


def point_neg(p: Point) -> Point:
    X, Y, Z = p
    return X, (F.fq2_neg(Y) if Y.dim() == 3 else F.neg(Y, FQ)), Z


def point_madd(p: Point, q: AffinePoint) -> Point:
    """Jacobian p plus affine q ((0, 0) = infinity): K3, then, only when
    some lane hit the doubling case (p == q), K2's doubling of p in the
    flagged lanes (`curve_jax._point_madd_impl`, :242-265)."""
    (X3, Y3, Z3), same = K.point_madd(p, q)
    if bool(same.any()):
        dX, dY, dZ = point_double(p)
        X3, Y3, Z3 = (K.select_lanes(same, dX, X3),
                      K.select_lanes(same, dY, Y3),
                      K.select_lanes(same, dZ, Z3))
    return X3, Y3, Z3


def _one_coord(like: torch.Tensor) -> torch.Tensor:
    return OPS[K.group_of(like)].one(like)


def affine_to_jac(q: AffinePoint) -> Point:
    """(X, Y) affine -> Jacobian; the (0, 0) marker maps to Z = 0."""
    X, Y = q
    o = OPS[K.group_of(X)]
    inf = o.is_zero(X) & o.is_zero(Y)
    return X, Y, o.sel(inf, torch.zeros_like(X), _one_coord(X))


def to_affine(p: Point) -> AffinePoint:
    """Batch-normalize to affine (X/Z^2, Y/Z^3) with the (0, 0) infinity
    marker.  The inverse is Fermat over the whole batch (`pow_const`), as
    in the JAX package."""
    X, Y, Z = p
    o = OPS[K.group_of(X)]
    inf = o.is_zero(Z)
    Zs = o.sel(inf, _one_coord(Z), Z)
    Zi = F.fq2_inv(Zs) if Z.dim() == 3 else F.inv(Zs, FQ)
    (Zi2,) = o.mul_many([Zi], [Zi])
    Xa, Zi3 = o.mul_many([X, Zi2], [Zi2, Zi])
    (Ya,) = o.mul_many([Y], [Zi3])
    zero = torch.zeros_like(X)
    return o.sel(inf, zero, Xa), o.sel(inf, zero, Ya)


# ---------------------------------------------------------------------------
# Host <-> device conversion (golden points <-> limb batches)
# ---------------------------------------------------------------------------

def pack_g1(points, device=None) -> Point:
    """Golden G1 points -> Montgomery Jacobian batch (Z in {0, 1})."""
    xs, ys, zs = [], [], []
    for pt in points:
        x, y, z = (0, 1, 0) if pt.is_zero() else (pt.x.n, pt.y.n, 1)
        xs.append(x)
        ys.append(y)
        zs.append(z)
    return tuple(F.pack_mont(v, FQ, device) for v in (xs, ys, zs))


def pack_g2(points, device=None) -> Point:
    cols = [[] for _ in range(6)]
    for pt in points:
        if pt.is_zero():
            vals = (0, 0, 1, 0, 0, 0)
        else:
            vals = (pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n, 1, 0)
        for c, v in zip(cols, vals):
            c.append(v)
    packed = [F.pack_mont(c, FQ, device) for c in cols]
    return tuple(torch.stack(packed[2 * i:2 * i + 2]) for i in range(3))


def unpack_g1(p: Point):
    """Limb batch -> golden affine G1 points."""
    P = params.P
    X, Y, Z = (F.unpack_mont(c, FQ) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(G1.zero())
        else:
            zi = pow(z, -1, P)
            zi2 = zi * zi % P
            out.append(G1(Fq(x * zi2 % P), Fq(y * zi2 % P * zi % P)))
    return out


def unpack_g2(p: Point):
    comps = [F.unpack_mont(c[i], FQ) for c in p for i in range(2)]
    out = []
    for x0, x1, y0, y1, z0, z1 in zip(*comps):
        if z0 == 0 and z1 == 0:
            out.append(G2.zero())
        else:
            zi = Fq2.of_ints(z0, z1).inv()
            zi2 = zi * zi
            out.append(G2(Fq2.of_ints(x0, x1) * zi2,
                          Fq2.of_ints(y0, y1) * zi2 * zi))
    return out


def infinity_g1(n: int, device=None) -> Point:
    z = F.zeros(n, FQ, device)
    return (z, F.ones_mont(n, FQ, device), z.clone())


def infinity_g2(n: int, device=None) -> Point:
    z = torch.zeros((2, FQ.nl, n), dtype=torch.int32, device=device)
    one = torch.stack([F.ones_mont(n, FQ, device), F.zeros(n, FQ, device)])
    return (z, one, z.clone())


def infinity(group: str, n: int, device=None) -> Point:
    return (infinity_g2 if group == "g2" else infinity_g1)(n, device)


# ---------------------------------------------------------------------------
# Repacking point batches from and to the JAX package's 16-bit layout
# ---------------------------------------------------------------------------

def from_jax(points, device=None):
    """JAX affine (X, Y) or Jacobian (X, Y, Z) batch (numpy arrays, G1
    coordinates (24, N), G2 (2, 24, N)) -> the port's batch."""
    return tuple(F.from_jax(np.asarray(c), axis=-2, device=device)
                 for c in points)


def to_jax(points):
    return tuple(F.to_jax(c, axis=-2) for c in points)
