"""The plain Groth16 reference of a circuit with ragged rows: any number of
terms on each side of a row, any coefficients, any public columns.

The accepted Groth16 reference (`zkbench.reference.groth16`) takes one
term of coefficient 1 a side.  This one sums every term of every row with
its coefficient:

  A(tau) = sum_g L_g(tau) sum_t c_gt z_(col gt)     (B, C alike)

and the mid sums leave out the terms whose column is public (ONE and the
public inputs).  Everything else (the MSM results, the proof, the
reduction's values at tau, the judge and its limits) is the accepted
reference's, which this class extends.  Python integers only; it imports
nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence

from . import groth16 as g16

R = g16.R
judge = g16.judge
LIMITS = dict(g16.LIMITS)


class R1CSReference(g16.Groth16Reference):
    """gates: the l, r and o sides, each (offsets (G + 1), cols (nnz),
    coefs (nnz)) with row g's terms at offsets[g] .. offsets[g + 1] - 1;
    witnesses: the pool, values by column; ios: the public columns."""

    def __init__(self, gates: Sequence[tuple], witnesses: Sequence[list],
                 ios: Sequence[int], logn: int, trapdoor: Sequence[int],
                 generator: int, two_adicity: int):
        self.alpha, self.beta, self.gamma, self.delta, self.tau = (
            int(t) % R for t in trapdoor)
        self.logn, self.n = logn, 1 << logn
        self.sides = [([int(o) for o in off], [int(c) for c in cols],
                       [int(c) % R for c in coefs])
                      for off, cols, coefs in gates]
        omega = g16.root_of_unity(logn, generator, two_adicity)
        self.lag = g16.lagrange_at(self.tau, logn, len(self.sides[0][0]) - 1,
                                   omega)
        self.z_tau = (pow(self.tau, self.n, R) - 1) % R
        self.dinv = pow(self.delta, -1, R)
        self.ios = set(int(c) for c in ios)
        self.witnesses = witnesses
        self._scalars = {}
        self._tau_pows = None
        self.g1 = g16.bls.g1_base()
        self.g2 = g16.bls.g2_base()

    def row_sums(self, side: tuple, w: Sequence[int], public: bool
                 ) -> List[int]:
        """Each row's sum of c_t z_(col t) over its terms, or over its
        public columns' terms alone."""
        off, cols, coefs = side
        terms = [c * w[k] if not public or k in self.ios else 0
                 for k, c in zip(cols, coefs)]
        return [sum(terms[off[g]:off[g + 1]]) % R
                for g in range(len(off) - 1)]

    def scalars(self, widx: int) -> dict:
        """A(tau), B(tau), C(tau), the H and C-mid scalars of witness
        widx."""
        if widx not in self._scalars:
            w = self.witnesses[widx]
            full, mid = [], []
            for side in self.sides:
                tot = g16._dot(self.lag, self.row_sums(side, w, False))
                io = g16._dot(self.lag, self.row_sums(side, w, True))
                full.append(tot)
                mid.append((tot - io) % R)
            A, B, Cv = full
            self._scalars[widx] = {
                "A": A, "B": B, "C": Cv,
                "H": (A * B - Cv) % R * self.dinv % R,
                "Cmid": (self.beta * mid[0] + self.alpha * mid[1] + mid[2])
                        % R * self.dinv % R}
        return self._scalars[widx]


def for_instance(config: dict, inst, witnesses=None) -> R1CSReference:
    """The reference of a generated instance (`zkbench.circuits_sapling`),
    over its witness pool or over `witnesses` in its place."""
    return R1CSReference(
        inst.gates, inst.witnesses if witnesses is None else witnesses,
        inst.ios, inst.logn, inst.trapdoor,
        generator=int(config["fr_generator"]),
        two_adicity=int(config["fr_two_adicity"]))
