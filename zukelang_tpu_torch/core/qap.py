"""QAP construction and evaluation.

Mirrors `QAP.Make(F)` (src/lib/zk/QAP.ml): per-variable coefficient vectors
over gate ids are interpolated into polynomials v/w/y; the witness reduces
the circuit to the divisibility instance p = v*w - y = h * target.

Two interpolation domains are supported:

  * "reference" — gate id g becomes the field point g in 0..n-1, target
    prod(x - g)  (QAP.ml:81-92).  Matches the reference bit-for-bit; O(n^2)
    Lagrange, intended for small circuits and cross-checks.
  * "ntt" — gate g sits at omega^g over the radix-2 domain of size
    2^k >= n_gates (padded with vacuous 0 = 0*0 gates); target = x^N - 1.
    Same circuit semantics, but interpolation/division become NTTs — the
    device path (`ops/ntt.py`, `engine/torch_engine.py`).

The port's own copy of `zukelang_tpu/core/qap.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

from .. import params
from ..golden.field import Fr
from . import poly
from .circuit import Gate, gates_vars, sort_gates
from .var import Var


@dataclass
class QAP:
    v: Dict[Var, List[Fr]]
    w: Dict[Var, List[Fr]]
    y: Dict[Var, List[Fr]]
    target: List[Fr]
    domain: str = "reference"
    # For domain="ntt": log2 domain size; points are omega^g.
    logn: Optional[int] = None
    # gate id assignment used for building (sorted gate order, QAP.ml:22)
    gates: List[Gate] = dfield(default_factory=list)


def domain_points(n_gates: int, domain: str) -> Tuple[List[Fr], List[Fr]]:
    """Interpolation points and the vanishing target polynomial."""
    if domain == "reference":
        xs = [Fr(i) for i in range(n_gates)]
        return xs, poly.z(xs)
    if domain == "ntt":
        logn = max(1, (n_gates - 1).bit_length())
        n = 1 << logn
        omega = Fr(pow(params.FR_ROOT_OF_UNITY, 1 << (32 - logn), params.R))
        xs = []
        acc = Fr(1)
        for _ in range(n):
            xs.append(acc)
            acc = acc * omega
        # x^N - 1
        target = [Fr(-1)] + [Fr(0)] * (n - 1) + [Fr(1)]
        return xs, target
    raise ValueError(domain)


def build(gates: List[Gate], domain: str = "reference") -> QAP:
    """Circuit -> QAP (QAP.ml:18-94)."""
    gates = sort_gates(gates)
    vars_ = sorted(gates_vars(gates))
    n_gates = len(gates)
    xs, target = domain_points(n_gates, domain)

    basis = poly.lagrange_basis(xs[:n_gates] if domain == "reference" else xs)
    # For the NTT domain the basis spans the full padded domain; coefficient
    # vectors for padding gates are zero, so only the first n_gates matter.

    def side(select):
        out: Dict[Var, List[Fr]] = {}
        for k in vars_:
            acc = poly.zero()
            for g_id, g in enumerate(gates):
                coeff = select(g).m.get(k)
                if coeff is not None and not coeff.is_zero():
                    acc = poly.add(acc, poly.mul_scalar(coeff, basis[g_id]))
            out[k] = acc
        return out

    v = side(lambda g: g.l)
    w = side(lambda g: g.r)
    y = side(lambda g: g.lhs)

    logn = None
    if domain == "ntt":
        logn = (len(xs)).bit_length() - 1
    return QAP(v=v, w=w, y=y, target=target, domain=domain, logn=logn, gates=gates)


def decompile(qap: QAP) -> List[Gate]:
    """Inverse sanity check (QAP.ml:96-118): recover gates from polynomials."""
    from .circuit import Affine

    n_gates = len(qap.gates)
    xs, _ = domain_points(n_gates, qap.domain)
    out = []
    for g_id in range(n_gates):
        x = xs[g_id]

        def pick(m):
            d = {}
            for k, p in m.items():
                val = poly.apply(p, x)
                if not val.is_zero():
                    d[k] = val
            return Affine(d)

        out.append(Gate(pick(qap.y), pick(qap.v), pick(qap.w)))
    return out


def eval_witness(sol: Dict[Var, Fr], qap: QAP) -> Tuple[List[Fr], List[Fr]]:
    """Witness -> (p, h) with p = h * target (QAP.ml:120-135)."""

    def combine(polys: Dict[Var, List[Fr]]) -> List[Fr]:
        acc = poly.zero()
        for k, p in polys.items():
            acc = poly.add(acc, poly.mul_scalar(sol[k], p))
        return acc

    v = combine(qap.v)
    w = combine(qap.w)
    y = combine(qap.y)
    p = poly.sub(poly.mul(v, w), y)
    h, rem = poly.div_rem(p, qap.target)
    if not poly.is_zero(rem):
        raise AssertionError("witness does not satisfy the QAP (nonzero remainder)")
    return p, h
