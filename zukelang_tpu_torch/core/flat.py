"""Flattening circuits into static-shape arrays for the torch engine.

Counterpart of `zukelang_tpu/core/flat.py`, packed with numpy into the
port's 32-bit limbs:

  * a variable index (sorted variables -> columns),
  * each of l / r / lhs as ragged rows: row offsets (G + 1), then the
    column and the coefficient of every term in row order, so that a row
    of one term and a row of 255 take their own sizes (the JAX package
    pads every row to the widest, (G, K)): the forward matvec per gate,
    and
  * var-sorted nnz triplets: the transpose matvec A_k(tau) = sum_g
    coeff(k, g) * L_g(tau) per variable (keygen side).

Coefficients are Montgomery-form uint32 limb arrays, (8, ...) for Fr.

Two ways in: `flatten(gates)` takes any gates with the fields of
`core.circuit.Gate` (`lhs`, `l`, `r`, each an affine with a `.m` dict
from variable to a coefficient carrying its int in `.n`), this package's
or the JAX package's, and orders them as `circuit.sort_gates` does;
`from_arrays` takes the rows as plain integer arrays, dense and padded
or ragged, with the columns 0..V-1 as the variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import util
from ..golden.field import Fr
from ..ops import field as F
from ..params import FR
from .circuit import ONE, Affine, Gate, gates_vars, sort_gates
from .var import Var


def pack_mont_np(values, spec=FR) -> np.ndarray:
    """Ints -> (nl, N) uint32 Montgomery limbs (host array)."""
    return F._np_limbs([(int(v) % spec.p) * spec.R % spec.p for v in values],
                       spec.nl)


def pack_coefs(values) -> np.ndarray:
    """Coefficient ints -> (nl, N) uint32 Montgomery limbs, each distinct
    value packed once (a circuit's coefficients repeat: 1, -1, 2^i)."""
    index: Dict[int, int] = {}
    at = np.fromiter((index.setdefault(int(v) % FR.p, len(index))
                      for v in values), dtype=np.int64)
    return np.ascontiguousarray(pack_mont_np(list(index))[:, at])


def pack_witness_values(values: Sequence[int], device=None) -> torch.Tensor:
    """Witness ints by column -> Montgomery (nl, V+1) int32 tensor with a
    trailing zero column (the JAX package's padding column; ragged rows
    never read it).  Span
    `zk.flat.pack_witness`, host-only where it makes no device tensor."""
    host = device is None or torch.device(device).type == "cpu"
    with util.stage("zk.flat.pack_witness", host=host):
        return F._as_tensor(pack_mont_np(list(values) + [0]), device)


@dataclass
class FlatSide:
    """One of l / r / lhs as ragged rows + var-sorted triplets.  Row g's
    terms are offsets[g] .. offsets[g + 1] - 1."""
    offsets: np.ndarray    # (G + 1,) int64, offsets[0] = 0, offsets[G] = nnz
    cols: np.ndarray       # (nnz,) int32 var column per term, in row order
    coef: np.ndarray       # (nl, nnz) uint32 Montgomery coefficients
    t_var: np.ndarray      # (M,) int32 var column per nnz, ascending
    t_gate: np.ndarray     # (M,) int32 gate row per nnz
    t_coef: np.ndarray     # (nl, M) uint32 Montgomery coefficients
    # (offsets, cols, coef) int32 tensors by device, made at the first
    # prove there
    device_copies: dict = field(default_factory=dict, repr=False,
                                compare=False)

    @property
    def n_gates(self) -> int:
        return len(self.offsets) - 1

    @property
    def nnz(self) -> int:
        return len(self.cols)

    @property
    def widest(self) -> int:
        """The most terms in one row (0 for a side with no terms)."""
        return int(np.diff(self.offsets).max(initial=0))


@dataclass
class FlatCircuit:
    vars_sorted: List
    var_index: Dict
    n_gates: int
    logn: int              # NTT domain size = 2^logn >= n_gates
    l: FlatSide
    r: FlatSide
    lhs: FlatSide

    @property
    def domain_size(self):
        return 1 << self.logn

    @property
    def sides(self):
        return self.l, self.r, self.lhs

    @property
    def nnz(self) -> int:
        """Terms over the three sides."""
        return sum(s.nnz for s in self.sides)

    def pack_witness(self, sol: Dict, device=None) -> torch.Tensor:
        """Witness dict (variable -> value with `.n`) -> Montgomery
        (nl, V+1) int32 tensor, see `pack_witness_values`."""
        return pack_witness_values([sol[v].n for v in self.vars_sorted],
                                   device)


def flat_side(offsets, cols, coefs) -> FlatSide:
    """Ragged rows -> FlatSide: offsets (G + 1) into cols (nnz) var
    columns and coefs (nnz) standard-form ints.  Every term becomes a
    triplet, sorted by (var, gate)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int32).reshape(-1)
    G, nnz = len(offsets) - 1, len(cols)
    if G < 0 or offsets[0] != 0 or offsets[-1] != nnz or (
            np.diff(offsets) < 0).any():
        raise ValueError(f"row offsets do not split {nnz} terms into rows")
    if nnz >= 1 << 31:
        raise ValueError(f"{nnz} terms in a side: the card's offsets are "
                         "int32")
    coef = pack_coefs(coefs).reshape(FR.nl, nnz)
    if not nnz:
        return FlatSide(offsets=offsets, cols=cols, coef=coef,
                        t_var=np.zeros(1, np.int32),
                        t_gate=np.zeros(1, np.int32), t_coef=pack_mont_np([0]))
    gate = np.repeat(np.arange(G, dtype=np.int32), np.diff(offsets))
    order = np.lexsort((gate, cols))
    return FlatSide(offsets=offsets, cols=cols, coef=coef, t_var=cols[order],
                    t_gate=gate[order],
                    t_coef=np.ascontiguousarray(coef[:, order]))


def ragged_of_dense(idx, coefs, n_pad_col: int):
    """Dense rows (idx (G, K) var columns, `n_pad_col` where a row has
    fewer terms; coefs (G, K) ints) -> (offsets, cols, coefs) of the terms
    that are not padding, in row order."""
    idx = np.asarray(idx, dtype=np.int64)
    live = idx != n_pad_col
    flat = [c for row in coefs for c in row]
    keep = np.flatnonzero(live.reshape(-1))
    if len(keep) < len(flat):
        flat = [flat[i] for i in keep]
    offsets = np.concatenate([[0], np.cumsum(live.sum(1))])
    return offsets, idx[live], flat


def from_arrays(n_vars: int, logn: int, l, r, lhs) -> FlatCircuit:
    """A flat circuit over the columns 0..n_vars-1 from plain arrays.
    Each of l, r, lhs is either ragged rows, a triple (offsets (G + 1),
    cols (nnz), coefs (nnz)) as `flat_side` takes it, or dense rows, a
    pair (idx (G, K), coefs (G, K)) padded with column n_vars, whose
    padding is dropped.  Span `zk.flat.from_arrays` (host-only; `rows`,
    `nnz` and `widest` summed or taken over the three sides)."""
    with util.stage("zk.flat.from_arrays", host=True, vars=n_vars) as span:
        cols = list(range(n_vars))
        sides = [flat_side(*(s if len(s) == 3 else
                             ragged_of_dense(*s, n_vars)))
                 for s in (l, r, lhs)]
        if len({s.n_gates for s in sides}) != 1:
            raise ValueError("the sides have different numbers of rows")
        fc = FlatCircuit(vars_sorted=cols, var_index={v: v for v in cols},
                         n_gates=sides[0].n_gates, logn=logn,
                         l=sides[0], r=sides[1], lhs=sides[2])
        span.attrs.update(rows=fc.n_gates, nnz=fc.nnz,
                          widest=max(s.widest for s in sides))
        return fc


def column_var(col: int):
    """The variable of column `col` of a flat circuit made by
    `from_arrays`: ONE at column 0, Var("w", col) elsewhere.  The map
    keeps the columns' order (ONE sorts before every "w")."""
    return ONE if col == 0 else Var("w", col)


def gates_of(fc: FlatCircuit) -> List[Gate]:
    """The rows of a flat circuit made by `from_arrays` as `Gate`s over
    `column_var`s, row g the g-th gate.  Affine keys compare as the
    columns do, so where the rows are distinct and in the reference's
    gate order (`flatten`'s, or a chain whose lhs columns increase), the
    sorted gates keep the rows' order and `flatten` gives `fc` back."""

    def affines(side: FlatSide):
        coefs = F.unpack_mont(F._as_tensor(side.coef), FR)
        return [Affine({column_var(int(side.cols[t])): Fr(coefs[t])
                        for t in range(side.offsets[g], side.offsets[g + 1])})
                for g in range(side.n_gates)]

    return [Gate(lhs, l, r) for lhs, l, r in zip(affines(fc.lhs),
                                                  affines(fc.l),
                                                  affines(fc.r))]


def _rows(gates, pick, var_index):
    """One side of the gates -> (offsets, cols, coefs), each row's terms
    in variable order."""
    rows = [sorted(pick(g).m.items(), key=lambda kv: kv[0]) for g in gates]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    cols = [var_index[v] for row in rows for v, _c in row]
    return offsets, cols, [c.n for row in rows for _v, c in row]


def flatten(gates) -> FlatCircuit:
    gates = sort_gates(gates)
    vars_sorted = sorted(gates_vars(gates))
    var_index = {v: i for i, v in enumerate(vars_sorted)}
    n_gates = len(gates)
    sides = [flat_side(*_rows(gates, pick, var_index))
             for pick in (lambda g: g.l, lambda g: g.r, lambda g: g.lhs)]
    return FlatCircuit(
        vars_sorted=vars_sorted,
        var_index=var_index,
        n_gates=n_gates,
        logn=max(1, (max(n_gates, 2) - 1).bit_length()),
        l=sides[0], r=sides[1], lhs=sides[2])
