"""Flattening circuits into static-shape arrays for the torch engine.

Counterpart of `zukelang_tpu/core/flat.py`, packed with numpy into the
port's 32-bit limbs:

  * a variable index (sorted variables -> columns),
  * per-gate padded coefficient rows for l / r / lhs (dense (G, K) with
    K = max terms per affine): the forward matvec per gate, and
  * var-sorted nnz triplets: the transpose matvec A_k(tau) = sum_g
    coeff(k, g) * L_g(tau) per variable (keygen side).

Coefficients are Montgomery-form uint32 limb arrays, (8, ...) for Fr.

Two ways in: `flatten(gates)` takes any gates with the fields of
`core.circuit.Gate` (`lhs`, `l`, `r`, each an affine with a `.m` dict
from variable to a coefficient carrying its int in `.n`), this package's
or the JAX package's, and orders them as `circuit.sort_gates` does;
`from_arrays` takes the dense rows as plain integer arrays, with the
columns 0..V-1 as the variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..golden.field import Fr
from ..ops import field as F
from ..params import FR
from .circuit import ONE, Affine, Gate, gates_vars, sort_gates
from .var import Var


def pack_mont_np(values, spec=FR) -> np.ndarray:
    """Ints -> (nl, N) uint32 Montgomery limbs (host array)."""
    return F._np_limbs([(int(v) % spec.p) * spec.R % spec.p for v in values],
                       spec.nl)


def pack_witness_values(values: Sequence[int], device=None) -> torch.Tensor:
    """Witness ints by column -> Montgomery (nl, V+1) int32 tensor with a
    trailing zero column (the padding target of dense rows)."""
    return F._as_tensor(pack_mont_np(list(values) + [0]), device)


@dataclass
class FlatSide:
    """One of l / r / lhs as padded dense rows + var-sorted triplets."""
    idx: np.ndarray        # (G, K) int32 var column (or V for padding)
    coef: np.ndarray       # (nl, G, K) uint32 Montgomery coefficients
    t_var: np.ndarray      # (M,) int32 var column per nnz, ascending
    t_gate: np.ndarray     # (M,) int32 gate row per nnz
    t_coef: np.ndarray     # (nl, M) uint32 Montgomery coefficients
    # (idx, coef) tensors by device, made at the first prove there
    device_copies: dict = field(default_factory=dict, repr=False,
                                compare=False)


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

    def pack_witness(self, sol: Dict, device=None) -> torch.Tensor:
        """Witness dict (variable -> value with `.n`) -> Montgomery
        (nl, V+1) int32 tensor, see `pack_witness_values`."""
        return pack_witness_values([sol[v].n for v in self.vars_sorted],
                                   device)


def flat_side(idx, coefs, n_pad_col: int) -> FlatSide:
    """Dense rows -> FlatSide.  idx (G, K) var columns, `n_pad_col` where
    a row has fewer terms; coefs (G, K) standard-form ints.  Every entry
    that is not padding becomes a triplet, sorted by (var, gate)."""
    idx = np.asarray(idx, dtype=np.int32)
    G, K = idx.shape
    coef = pack_mont_np([c for row in coefs for c in row]).reshape(FR.nl, G, K)
    var = idx.reshape(-1)
    gate = np.repeat(np.arange(G, dtype=np.int32), K)
    live = np.nonzero(var != n_pad_col)[0]
    if not len(live):
        return FlatSide(idx=idx, coef=coef, t_var=np.zeros(1, np.int32),
                        t_gate=np.zeros(1, np.int32), t_coef=pack_mont_np([0]))
    order = live[np.lexsort((gate[live], var[live]))]
    return FlatSide(idx=idx, coef=coef, t_var=var[order], t_gate=gate[order],
                    t_coef=np.ascontiguousarray(
                        coef.reshape(FR.nl, G * K)[:, order]))


def from_arrays(n_vars: int, logn: int, l, r, lhs) -> FlatCircuit:
    """A flat circuit over the columns 0..n_vars-1 from plain arrays: each
    of l, r, lhs is a pair (idx (G, K), coefs (G, K)) as `flat_side`
    takes it, padded with column n_vars."""
    cols = list(range(n_vars))
    sides = [flat_side(i, c, n_vars) for i, c in (l, r, lhs)]
    return FlatCircuit(vars_sorted=cols, var_index={v: v for v in cols},
                       n_gates=sides[0].idx.shape[0], logn=logn,
                       l=sides[0], r=sides[1], lhs=sides[2])


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
    V = len(fc.vars_sorted)

    def affines(side: FlatSide):
        G, K = side.idx.shape
        coefs = F.unpack_mont(F._as_tensor(side.coef.reshape(FR.nl, G * K)),
                              FR)
        out = []
        for g in range(G):
            row = side.idx[g]
            out.append(Affine({column_var(int(row[k])): Fr(coefs[g * K + k])
                               for k in range(K) if row[k] != V}))
        return out

    return [Gate(lhs, l, r) for lhs, l, r in zip(affines(fc.lhs),
                                                  affines(fc.l),
                                                  affines(fc.r))]


def _rows(gates, pick, var_index, n_pad_col: int):
    rows = [sorted(pick(g).m.items(), key=lambda kv: kv[0]) for g in gates]
    K = max(1, max((len(r) for r in rows), default=1))
    idx = np.full((len(rows), K), n_pad_col, dtype=np.int32)
    coefs = [[0] * K for _ in rows]
    for gi, row in enumerate(rows):
        for j, (v, c) in enumerate(row):
            idx[gi, j] = var_index[v]
            coefs[gi][j] = c.n
    return idx, coefs


def flatten(gates) -> FlatCircuit:
    gates = sort_gates(gates)
    vars_sorted = sorted(gates_vars(gates))
    var_index = {v: i for i, v in enumerate(vars_sorted)}
    n_gates = len(gates)
    V = len(vars_sorted)
    sides = [flat_side(*_rows(gates, pick, var_index, V), V)
             for pick in (lambda g: g.l, lambda g: g.r, lambda g: g.lhs)]
    return FlatCircuit(
        vars_sorted=vars_sorted,
        var_index=var_index,
        n_gates=n_gates,
        logn=max(1, (max(n_gates, 2) - 1).bit_length()),
        l=sides[0], r=sides[1], lhs=sides[2])
