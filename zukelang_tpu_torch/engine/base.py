"""Engine interface + golden implementation.

The port's own copy of `zukelang_tpu/engine/base.py`; `get_engine("torch")`
gives the port's `TorchEngine` where the JAX package's gives `JaxEngine`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..core import poly, qap as qap_mod
from ..core.var import Var
from ..golden.curve import G1, G2
from ..golden.field import Fr


class Engine:
    """Batched crypto primitives consumed by the protocol layer.

    Group elements cross this boundary as golden G1/G2 points (affine,
    python ints) — small in count (one per CRS entry / proof element); the
    heavy inner loops happen behind these calls.
    """

    name = "abstract"

    # -- multi-scalar multiplication (reference: curve.ml:94-103 `dot`) ----
    def g1_dot(self, points: Sequence[G1], scalars: Sequence[Fr]) -> G1:
        raise NotImplementedError

    def g2_dot(self, points: Sequence[G2], scalars: Sequence[Fr]) -> G2:
        raise NotImplementedError

    # -- powers-of-tau tables (curve.ml:106-109) ---------------------------
    def g1_powers(self, d: int, s: Fr) -> List[G1]:
        raise NotImplementedError

    def g2_powers(self, d: int, s: Fr) -> List[G2]:
        raise NotImplementedError

    # -- polynomial evaluation in the exponent (curve.ml:112-118) ----------
    def g1_apply_powers(self, coeffs: Sequence[Fr], xis: Sequence[G1]) -> G1:
        return self.g1_dot(list(xis[: len(coeffs)]), list(coeffs))

    def g2_apply_powers(self, coeffs: Sequence[Fr], xis: Sequence[G2]) -> G2:
        return self.g2_dot(list(xis[: len(coeffs)]), list(coeffs))

    # -- batched fixed-base scalar mult: [g * s for s in scalars] ----------
    def g1_of_fr_batch(self, scalars: Sequence[Fr]) -> List[G1]:
        raise NotImplementedError

    def g2_of_fr_batch(self, scalars: Sequence[Fr]) -> List[G2]:
        raise NotImplementedError

    # -- QAP witness reduction: returns (p, h) -----------------------------
    def qap_eval(self, qap: qap_mod.QAP, sol: Dict[Var, Fr]) -> Tuple[List[Fr], List[Fr]]:
        raise NotImplementedError

    def qap_witness_reduction(self, qap: qap_mod.QAP, sol: Dict[Var, Fr]):
        """(A, B, h) where A = sum_k sol_k v_k, B = sum_k sol_k w_k (coeff
        lists) and h = (A*B - C)/target.  The prover-side workload."""
        raise NotImplementedError

    def qap_eval_at(self, qap: qap_mod.QAP, x: Fr):
        """({v_k(x)}, {w_k(x)}, {y_k(x)}) dicts over all variables.  The
        keygen-side workload."""
        raise NotImplementedError


class GoldenEngine(Engine):
    """Pure-Python engine: the reference's naive algorithms, verbatim."""

    name = "golden"

    def g1_dot(self, points, scalars):
        return G1.dot(list(points), list(scalars))

    def g2_dot(self, points, scalars):
        return G2.dot(list(points), list(scalars))

    def g1_powers(self, d, s):
        return G1.powers(d, s)

    def g2_powers(self, d, s):
        return G2.powers(d, s)

    def g1_of_fr_batch(self, scalars):
        return [G1.of_Fr(s) for s in scalars]

    def g2_of_fr_batch(self, scalars):
        return [G2.of_Fr(s) for s in scalars]

    def qap_eval(self, qap, sol):
        return qap_mod.eval_witness(sol, qap)

    def qap_witness_reduction(self, qap, sol):
        def combine(polys):
            acc = poly.zero()
            for k, p in polys.items():
                acc = poly.add(acc, poly.mul_scalar(sol[k], p))
            return acc

        a = combine(qap.v)
        b = combine(qap.w)
        c = combine(qap.y)
        p = poly.sub(poly.mul(a, b), c)
        h, rem = poly.div_rem(p, qap.target)
        if not poly.is_zero(rem):
            raise AssertionError("witness does not satisfy the QAP")
        return a, b, h

    def qap_eval_at(self, qap, x):
        v = {k: poly.apply(p, x) for k, p in qap.v.items()}
        w = {k: poly.apply(p, x) for k, p in qap.w.items()}
        y = {k: poly.apply(p, x) for k, p in qap.y.items()}
        return v, w, y


def get_engine(name: str = None, **kw) -> Engine:
    """Engine registry; `None` returns the golden engine, "torch" the
    device one (`TorchEngine(**kw)`: the card unless `device` names
    another)."""
    if name in (None, "golden"):
        return GoldenEngine()
    if name == "torch":
        from .torch_engine import TorchEngine
        return TorchEngine(**kw)
    raise KeyError(name)
