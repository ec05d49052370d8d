"""Circuit IR: sparse affine combinations and multiplication gates.

The port's own copy of `zukelang_tpu/core/circuit.py`.

Mirrors the reference's `Circuit.Make(F)` (src/lib/zk/circuit.ml): a gate
`{lhs; l; r}` asserts lhs = l * r where each part is a sparse Var->coeff
affine combination; affine additions are free (folded into gate operands).
Constants ride on the distinguished ONE variable (circuit.ml:3).

Gate sets iterate in the reference's OCaml `Set` order (circuit.ml:84-105):
gates sorted by (lhs, l, r) with affines compared as sorted association
lists — QAP gate ids depend on this order, so it is reproduced exactly.

The field F is pluggable (golden Fr by default): any class with
zero()/one()/of_int/+/-/*/inv and a canonical `.n` int.
"""

from __future__ import annotations

from typing import Dict, Iterable

from . import var as var_mod
from .var import Var

# The distinguished "ONE" wire, allocated first at import time (circuit.ml:3).
ONE = var_mod.make("ONE")


class Affine:
    """Immutable sparse linear combination sum_v coeff_v * v  (+ c * ONE)."""

    __slots__ = ("m",)

    def __init__(self, m: Dict[Var, object]):
        self.m = dict(m)

    # -- constructors ------------------------------------------------------
    @classmethod
    def of_var(cls, v: Var, field):
        return cls({v: field.one()})

    @classmethod
    def of_F(cls, f):
        if f.is_zero():
            return cls({})
        return cls({ONE: f})

    @classmethod
    def of_int(cls, i: int, field):
        return cls.of_F(field.of_int(i))

    @classmethod
    def zero(cls):
        return cls({})

    # -- algebra (circuit.ml:37-57) ---------------------------------------
    def add(self, o: "Affine") -> "Affine":
        m = dict(self.m)
        for v, f in o.m.items():
            m[v] = m[v] + f if v in m else f
        # NB: union keeps zero coefficients, like the reference's
        # Var.Map.union (circuit.ml:39) — do not prune.
        return Affine(m)

    def mul_scalar(self, f) -> "Affine":
        return Affine({v: c * f for v, c in self.m.items()})

    def neg(self) -> "Affine":
        if not self.m:
            return self
        any_f = next(iter(self.m.values()))
        return self.mul_scalar(type(any_f).of_int(-1))

    def sub(self, o: "Affine") -> "Affine":
        if o.is_zero():
            return self
        any_f = next(iter(o.m.values()))
        minus_one = type(any_f).of_int(-1)
        return self.add(o.mul_scalar(minus_one))

    def is_zero(self) -> bool:
        return not self.m

    def is_const(self, field):
        """The constant c if the affine is c * ONE (or empty = 0), else None
        (circuit.ml:51-57)."""
        if any(v != ONE for v in self.m):
            return None
        return self.m.get(ONE, field.zero())

    def vars(self):
        return set(self.m.keys())

    def eval(self, env: Dict[Var, object], field):
        acc = field.zero()
        for v, c in self.m.items():
            acc = acc + env[v] * c
        return acc

    # -- ordering / identity ----------------------------------------------
    def key(self):
        """OCaml Var.Map.compare order: sorted (key, value) assoc list."""
        return _affine_key(self)

    def __eq__(self, o):
        return isinstance(o, Affine) and self.key() == o.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        if not self.m:
            return "0"
        parts = []
        for v, c in sorted(self.m.items()):
            if v == ONE:
                parts.append(f"{c!r}")
            elif c.n == 1:
                parts.append(f"{v!r}")
            else:
                parts.append(f"{v!r}*{c!r}")
        return " + ".join(parts)


class Gate:
    """lhs = l * r  (circuit.ml:73-106)."""

    __slots__ = ("lhs", "l", "r")

    def __init__(self, lhs: Affine, l: Affine, r: Affine):
        self.lhs, self.l, self.r = lhs, l, r

    def key(self):
        return _gate_key(self)

    def __eq__(self, o):
        return isinstance(o, Gate) and self.key() == o.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"{self.lhs!r} = ({self.l!r}) * ({self.r!r})"

    def vars(self):
        return self.lhs.vars() | self.l.vars() | self.r.vars()


def _affine_key(aff):
    """`Affine.key` from the fields alone (`.m`, a dict from variable to a
    coefficient with `.n`), so that gates of the JAX package sort too."""
    return tuple((v.name, v.id, c.n) for v, c in sorted(aff.m.items()))


def _gate_key(g):
    return (_affine_key(g.lhs), _affine_key(g.l), _affine_key(g.r))


def sort_gates(gates: Iterable[Gate]):
    """Distinct gates in the reference Gate.Set iteration order — QAP gate
    ids come from this (QAP.ml:22).  Takes any gates with `lhs`, `l`, `r`
    affines (this package's or the JAX package's)."""
    unique = {_gate_key(g): g for g in gates}
    return [unique[k] for k in sorted(unique)]


def gates_vars(gates: Iterable[Gate]):
    out = set()
    for g in gates:
        for aff in (g.lhs, g.l, g.r):
            out |= set(aff.m)
    return out


class Circuit:
    """{gates; inputs_public; outputs; mids}  (circuit.ml:108-134)."""

    def __init__(self, gates, inputs_public, outputs, mids):
        self.gates = sort_gates(gates)
        self.inputs_public = set(inputs_public)
        self.outputs = set(outputs)
        self.mids = set(mids)

    def vars(self):
        return gates_vars(self.gates)

    def ios(self):
        return self.vars() - self.mids

    def __repr__(self):
        gs = "\n  ".join(repr(g) for g in self.gates)
        return (f"Circuit(\n  gates:\n  {gs}\n"
                f"  inputs_public: {sorted(self.inputs_public)}\n"
                f"  outputs: {sorted(self.outputs)}\n"
                f"  mids: {sorted(self.mids)})")
