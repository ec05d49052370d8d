"""The plain Groth16 reference that decides `correct`.

It knows the trapdoor (alpha, beta, gamma, delta, tau), because the
benchmark draws it from the seed and hands it to the program.  Every table
point of the proving key is then a known multiple of a generator, so each
MSM of a prove has a known answer: the MSM of the coefficients of A
against {tau^i G1} is A(tau) G1.  The reference works out the scalars
from the witness and the gates alone, over the same evaluation domain, and
compares points, never the program's intermediate values with each other:

  A(tau) = sum_g L_g(tau) a_g   (a_g the left term of gate g; B, C alike)
  L_g(x) = (x^N - 1) / N * w^g / (x - w^g)       (w: the domain's root)
  MSM results  A: A(tau) G1, B1: B(tau) G1, B: B(tau) G2,
               H: (A(tau) B(tau) - C(tau)) / delta G1,
               C-mid: (beta A_mid + alpha B_mid + C_mid)(tau) / delta G1
  proof        a = (alpha + A + r delta) G1,  b = (beta + B + s delta) G2,
               c = (Cmid + H + s a + r b1 - r s delta) G1,
               b1 = beta + B + s delta
  reduction    the program's coefficients of A and B evaluated at tau equal
               A(tau) and B(tau); those of h satisfy
               h(tau) Z(tau) = A(tau) B(tau) - C(tau), and h's top
               coefficient (degree N - 1) is 0.

The evaluation at tau is a Schwartz-Zippel test: two different
polynomials of degree below N agree at a random point with probability
at most N / R (< 2^-230).  Each comparison is exact.
"""

from __future__ import annotations

import operator
from itertools import accumulate
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import bls12_381 as bls

R = bls.R
MONT_RINV = pow(1 << 256, -1, R)   # the program's Fr Montgomery radix


def root_of_unity(logn: int, generator: int, two_adicity: int) -> int:
    w = pow(generator, (R - 1) >> two_adicity, R)
    return pow(w, 1 << (two_adicity - logn), R)


def _prod_mod(xs, init=1):
    return accumulate(xs, lambda a, b: a * b % R, initial=init)


def batch_inverse(xs: List[int]) -> List[int]:
    """Montgomery's trick: every inverse for one modular inversion."""
    pre = list(_prod_mod(xs))                 # pre[i] = x_0 ... x_{i-1}
    inv = pow(pre[-1], -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = inv * pre[i] % R
        inv = inv * xs[i] % R
    return out


def lagrange_at(x: int, logn: int, n_gates: int, omega: int) -> List[int]:
    """L_g(x) for the first n_gates points of the 2^logn domain."""
    n = 1 << logn
    ws = list(_prod_mod([omega] * (n_gates - 1)))          # w^0 .. w^(G-1)
    zn = (pow(x, n, R) - 1) * pow(n, -1, R) % R
    inv = batch_inverse([(x - w) % R for w in ws])
    return [zn * w % R * d % R for w, d in zip(ws, inv)]


def _dot(xs, ys) -> int:
    return sum(map(operator.mul, xs, ys)) % R


def mont_values(limbs: np.ndarray) -> List[int]:
    """(8, N) uint32 limbs, least significant first -> the N integers as
    stored (still in Montgomery form)."""
    raw = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32).T).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


class Groth16Reference:
    """Expected MSM results, proofs and reduction values of one instance.

    gates: (l, r, o) int arrays, the column of the single term (coefficient
    1) on the left, right and output side of each gate; witnesses: the
    pool, values by column; ios: the public columns (the rest are mids)."""

    def __init__(self, gates: Sequence[np.ndarray], witnesses: Sequence[list],
                 ios: Sequence[int], logn: int, trapdoor: Sequence[int],
                 generator: int, two_adicity: int):
        self.alpha, self.beta, self.gamma, self.delta, self.tau = (
            int(t) % R for t in trapdoor)
        self.logn, self.n = logn, 1 << logn
        omega = root_of_unity(logn, generator, two_adicity)
        self.lag = lagrange_at(self.tau, logn, len(gates[0]), omega)
        self.z_tau = (pow(self.tau, self.n, R) - 1) % R
        self.dinv = pow(self.delta, -1, R)
        self.gates = [np.asarray(g, dtype=np.int64).tolist() for g in gates]
        ios = set(int(c) for c in ios)
        # gates whose side names a public column: their terms leave the
        # mid sums (only a handful in these circuits)
        self.io_rows = [[g for g, c in enumerate(side) if c in ios]
                        for side in self.gates]
        self.witnesses = witnesses
        self._scalars: Dict[int, dict] = {}
        self._tau_pows: Optional[List[int]] = None
        self.g1 = bls.g1_base()
        self.g2 = bls.g2_base()

    # -- scalars --------------------------------------------------------
    def scalars(self, widx: int) -> dict:
        """A(tau), B(tau), C(tau), the H and C-mid scalars of witness widx."""
        if widx not in self._scalars:
            w = self.witnesses[widx]
            full, mid = [], []
            for side, io_rows in zip(self.gates, self.io_rows):
                vals = list(map(w.__getitem__, side))
                tot = _dot(self.lag, vals)
                io = sum(self.lag[g] * vals[g] for g in io_rows) % R
                full.append(tot)
                mid.append((tot - io) % R)
            A, B, Cv = full
            self._scalars[widx] = {
                "A": A, "B": B, "C": Cv,
                "H": (A * B - Cv) % R * self.dinv % R,
                "Cmid": (self.beta * mid[0] + self.alpha * mid[1] + mid[2])
                        % R * self.dinv % R}
        return self._scalars[widx]

    def msm_points(self, widx: int) -> dict:
        """The five MSM results of a prove of witness widx."""
        s = self.scalars(widx)
        return {"g1": [self.g1.mul(s[k]) for k in ("A", "B", "H", "Cmid")],
                "g2": [self.g2.mul(s["B"])]}

    def proof_scalars(self, widx: int, r: int, s: int) -> tuple:
        sc = self.scalars(widx)
        a = (self.alpha + sc["A"] + r * self.delta) % R
        b = (self.beta + sc["B"] + s * self.delta) % R
        c = (sc["Cmid"] + sc["H"] + s * a + r * b
             - r * s % R * self.delta) % R
        return a, b, c

    def proof_points(self, widx: int, r: int, s: int) -> tuple:
        a, b, c = self.proof_scalars(widx, r, s)
        return self.g1.mul(a), self.g2.mul(b), self.g1.mul(c)

    # -- the witness reduction -------------------------------------------
    def tau_pows(self) -> List[int]:
        if self._tau_pows is None:
            self._tau_pows = list(_prod_mod([self.tau] * (self.n - 1)))
        return self._tau_pows

    def eval_coeffs(self, limbs: np.ndarray, count: int) -> int:
        """The first `count` Montgomery coefficients, evaluated at tau."""
        vals = mont_values(np.asarray(limbs)[:, :count])
        return _dot(vals, self.tau_pows()) * MONT_RINV % R

    def reduction_values(self, a, b, h) -> tuple:
        """The program's reduction outputs (8, N) limb arrays -> A(tau),
        B(tau), h(tau) over its first N - 1 coefficients, and its top
        coefficient."""
        n = self.n
        top = mont_values(np.asarray(h)[:, n - 1:n])[0] * MONT_RINV % R
        return (self.eval_coeffs(a, n), self.eval_coeffs(b, n),
                self.eval_coeffs(h, n - 1), top)

    def reduction_ok(self, widx: int, values: tuple) -> bool:
        A, B, Hv, top = values
        s = self.scalars(widx)
        return (A == s["A"] and B == s["B"] and top == 0
                and Hv * self.z_tau % R == (s["A"] * s["B"] - s["C"]) % R)


def for_instance(config: dict, inst, witnesses=None) -> Groth16Reference:
    """The reference of a generated instance (`zkbench.generator`), over
    its witness pool or over `witnesses` in its place."""
    return Groth16Reference(
        inst.gates, inst.witnesses if witnesses is None else witnesses,
        inst.ios, inst.logn, inst.trapdoor,
        generator=int(config["fr_generator"]),
        two_adicity=int(config["fr_two_adicity"]))


def _key(p):
    return (0,) if p is None else (1, p)


def judge(ref: Groth16Reference, proofs: Sequence[dict]) -> Dict[str, int]:
    """Compare every proof of a run.  Each entry: `widx`, `r`, `s`,
    `proof` (a, b, c affine), `g1` and `g2` (the MSM results the prove
    produced, affine, in any order) and, for sampled proves, `reduction`
    (`Groth16Reference.reduction_values` of its outputs).  -> the counts
    of proofs checked and of those that disagree, layer by layer."""
    out = {"proofs": len(proofs), "failed": 0, "proof_mismatch": 0,
           "msm_mismatch": 0, "reduction_checked": 0,
           "reduction_mismatch": 0}
    for p in proofs:
        exp = ref.msm_points(p["widx"])
        bad = {"msm_mismatch": (
            sorted(map(_key, p["g1"])) != sorted(map(_key, exp["g1"]))
            or sorted(map(_key, p["g2"])) != sorted(map(_key, exp["g2"]))),
            "proof_mismatch": tuple(p["proof"]) != ref.proof_points(
                p["widx"], p["r"], p["s"])}
        if p.get("reduction") is not None:
            out["reduction_checked"] += 1
            bad["reduction_mismatch"] = not ref.reduction_ok(
                p["widx"], p["reduction"])
        for k, v in bad.items():
            out[k] += v
        out["failed"] += any(bad.values())
    return out


# The numbers `judge` gives and the limit of each: every proof, MSM result
# and sampled reduction must equal the reference's (exact comparisons), and
# a run must have proofs and a checked reduction to compare.
LIMITS = {"proofs": (">=", 1), "reduction_checked": (">=", 1),
          "failed": ("<=", 0), "proof_mismatch": ("<=", 0),
          "msm_mismatch": ("<=", 0), "reduction_mismatch": ("<=", 0)}
