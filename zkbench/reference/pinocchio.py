"""The plain Pinocchio reference that decides `correct`: Protocol 2 of
Parno, Howell, Gentry and Raykova (eprint 2013/279), NonZK and ZK, as
zukelang's `pinocchio.ml` states it (keygen :77-189, prove :193-250, ZK
prove :423-515).

It knows the trapdoor (rv, rw, s, av, aw, ay, b, gm), which the benchmark
draws from the seed and hands to the program, and each prove's (dv, dw,
dy).  Every point of the proving key is then a known multiple of a
generator, and so is every MSM result and every proof point.  The
reference works out those multiples from the witness and the gates alone,
over the same evaluation domain, and compares points:

  V(x) = sum_g L_g(x) k_g c_(l_g)     (k_g the gate's coefficient, c the
  W(x), Y(x) alike, over the right     witness, l_g its left column)
  and output sides
  L_g(x) = (x^N - 1) / N * w^g / (x - w^g)         (w: the domain's root)
  T = Z(s) = s^N - 1,  H = (V W - Y)(s) / T,  ry = rv rw
  _mid: the sum over the gates whose column on that side is a mid
  _held: over the columns below `held`, those the key holds on the card
  MSM results, G1  vv: rv V_mid,  yy: ry Y_mid,  h: H,  vavv: av rv V_mid,
                   yayy: ay ry Y_mid,
                   bvwy: b (rv V_mid + rw W_mid + ry Y_mid),
                   ZK: v_all: V_held,  w_all: W_held
              G2  ww: rw W_mid,  waww: aw rw W_mid
  proof, with V' = V_mid + dv T, W' = W_mid + dw T, Y' = Y_mid + dy T
  (NonZK: dv = dw = dy = 0)
               vv = rv V',  ww = rw W' (G2),  yy = ry Y',
               h = H + dw V + dv W + dv dw T - dy,
               vavv = av rv V',  waww = aw rw W' (G2),  yayy = ay ry Y',
               bvwy = b (rv V' + rw W' + ry Y')
  reduction    the program's coefficients of V and W evaluated at s equal
               V(s) and W(s); those of h satisfy h(s) T = V(s) W(s) - Y(s),
               and h's top coefficient (degree N - 1) is 0.

The ZK h follows from (V + dv T)(W + dw T) - (Y + dy T) = T (H + dw V +
dv W + dv dw T - dy), with V, W, Y over every column (ONE and the public
columns included).  The evaluation at s is a Schwartz-Zippel test: two
different polynomials of degree below N agree at a random point with
probability at most N / R (< 2^-230).  Each comparison is exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import bls12_381 as bls
from .groth16 import (MONT_RINV, _dot, _key, _prod_mod, lagrange_at,
                      mont_values, root_of_unity)

R = bls.R
# The proof's points in order, and the group of each.
PROOF = ("vv", "ww", "yy", "h", "vavv", "waww", "yayy", "bvwy")
G2_POINTS = ("ww", "waww")


class PinocchioReference:
    """Expected MSM results, proofs and reduction values of one instance.

    gates: (l, r, o) int arrays, the column of the single term on the
    left, right and output side of each gate; coefs: each gate's
    coefficient (one for all three sides); witnesses: the pool, values by
    column; ios: the public columns (the rest are mids); trapdoor: rv, rw,
    s, av, aw, ay, b, gm; held: the columns the key's all-variable tables
    hold on the card (the rest are its tails)."""

    def __init__(self, gates: Sequence[np.ndarray], coefs: Sequence[int],
                 witnesses: Sequence[list], ios: Sequence[int], logn: int,
                 trapdoor: Sequence[int], held: int, generator: int,
                 two_adicity: int, zk: bool):
        (self.rv, self.rw, self.s, self.av, self.aw, self.ay, self.b,
         _gm) = (int(t) % R for t in trapdoor)
        self.ry = self.rv * self.rw % R
        self.logn, self.n, self.held, self.zk = logn, 1 << logn, held, zk
        omega = root_of_unity(logn, generator, two_adicity)
        lag = lagrange_at(self.s, logn, len(gates[0]), omega)
        coefs = [int(k) % R for k in coefs]
        self.lag = [x * k % R for x, k in zip(lag, coefs)]   # L_g(s) k_g
        self.t = (pow(self.s, self.n, R) - 1) % R
        self.tinv = pow(self.t, -1, R)
        self.gates = [np.asarray(g, dtype=np.int64).tolist() for g in gates]
        ios = set(int(c) for c in ios)
        # the gates whose side names a public column, or a column beyond
        # `held`: their terms leave the mid sums, the held sums (few)
        self.io_rows = [[g for g, c in enumerate(side) if c in ios]
                        for side in self.gates]
        self.tail_rows = [[g for g, c in enumerate(side) if c >= held]
                          for side in self.gates]
        self.witnesses = witnesses
        self._scalars: Dict[int, dict] = {}
        self._msm: Dict[int, dict] = {}
        self._s_pows: Optional[List[int]] = None
        self.g1 = bls.g1_base()
        self.g2 = bls.g2_base()

    # -- scalars --------------------------------------------------------
    def scalars(self, widx: int) -> dict:
        """V, W, Y at s over every column, over the mids, over the held
        columns, and H, of witness widx."""
        if widx not in self._scalars:
            w = self.witnesses[widx]
            out = {}
            for name, side, io_rows, tail_rows in zip(
                    "VWY", self.gates, self.io_rows, self.tail_rows):
                vals = list(map(w.__getitem__, side))
                tot = _dot(self.lag, vals)
                out[name] = tot
                out[name + "mid"] = (tot - sum(self.lag[g] * vals[g]
                                               for g in io_rows)) % R
                out[name + "held"] = (tot - sum(self.lag[g] * vals[g]
                                                for g in tail_rows)) % R
            out["H"] = (out["V"] * out["W"] - out["Y"]) % R * self.tinv % R
            self._scalars[widx] = out
        return self._scalars[widx]

    def msm_scalars(self, widx: int) -> dict:
        """The multiples of G1 and of G2 that the prove's MSMs give."""
        sc = self.scalars(widx)
        vm, wm, ym = sc["Vmid"], sc["Wmid"], sc["Ymid"]
        rv_v, rw_w, ry_y = self.rv * vm % R, self.rw * wm % R, self.ry * ym % R
        g1 = [rv_v, ry_y, sc["H"], self.av * rv_v % R, self.ay * ry_y % R,
              self.b * (rv_v + rw_w + ry_y) % R]
        if self.zk:
            g1 += [sc["Vheld"], sc["Wheld"]]
        return {"g1": g1, "g2": [rw_w, self.aw * rw_w % R]}

    def msm_points(self, widx: int) -> dict:
        """The MSM results of a prove of witness widx (cached: they depend
        on the witness alone)."""
        if widx not in self._msm:
            k = self.msm_scalars(widx)
            self._msm[widx] = {"g1": [self.g1.mul(x) for x in k["g1"]],
                               "g2": [self.g2.mul(x) for x in k["g2"]]}
        return self._msm[widx]

    def proof_scalars(self, widx: int, d: Sequence[int]) -> dict:
        """The multiple of its generator of each proof point, for the
        prove's (dv, dw, dy) (NonZK: all zero)."""
        dv, dw, dy = (int(x) % R for x in d) if self.zk else (0, 0, 0)
        sc, t = self.scalars(widx), self.t
        v2 = self.rv * (sc["Vmid"] + dv * t) % R
        w2 = self.rw * (sc["Wmid"] + dw * t) % R
        y2 = self.ry * (sc["Ymid"] + dy * t) % R
        h2 = (sc["H"] + dw * sc["V"] + dv * sc["W"] + dv * dw % R * t
              - dy) % R
        return {"vv": v2, "ww": w2, "yy": y2, "h": h2,
                "vavv": self.av * v2 % R, "waww": self.aw * w2 % R,
                "yayy": self.ay * y2 % R,
                "bvwy": self.b * (v2 + w2 + y2) % R}

    def proof_points(self, widx: int, d: Sequence[int]) -> tuple:
        k = self.proof_scalars(widx, d)
        return tuple((self.g2 if name in G2_POINTS else self.g1).mul(k[name])
                     for name in PROOF)

    # -- the witness reduction -------------------------------------------
    def s_pows(self) -> List[int]:
        if self._s_pows is None:
            self._s_pows = list(_prod_mod([self.s] * (self.n - 1)))
        return self._s_pows

    def eval_coeffs(self, limbs: np.ndarray, count: int) -> int:
        """The first `count` Montgomery coefficients, evaluated at s."""
        vals = mont_values(np.asarray(limbs)[:, :count])
        return _dot(vals, self.s_pows()) * MONT_RINV % R

    def reduction_values(self, a, b, h) -> tuple:
        """The program's reduction outputs (8, N) limb arrays -> V(s),
        W(s), h(s) over its first N - 1 coefficients, and its top
        coefficient."""
        n = self.n
        top = mont_values(np.asarray(h)[:, n - 1:n])[0] * MONT_RINV % R
        return (self.eval_coeffs(a, n), self.eval_coeffs(b, n),
                self.eval_coeffs(h, n - 1), top)

    def reduction_ok(self, widx: int, values: tuple) -> bool:
        V, W, Hv, top = values
        sc = self.scalars(widx)
        return (V == sc["V"] and W == sc["W"] and top == 0
                and Hv * self.t % R == (sc["V"] * sc["W"] - sc["Y"]) % R)


def for_instance(config: dict, inst, coefs, held: int,
                 witnesses=None) -> PinocchioReference:
    """The reference of a padded instance (`zkbench.protocols.pinocchio`)
    whose key holds its first `held` columns on the card, over its witness
    pool or over `witnesses` in its place."""
    return PinocchioReference(
        inst.gates, coefs, inst.witnesses if witnesses is None else witnesses,
        inst.ios, inst.logn, inst.trapdoor, held=held,
        generator=int(config["fr_generator"]),
        two_adicity=int(config["fr_two_adicity"]), zk=bool(config["zk"]))


def judge(ref: PinocchioReference, proofs: Sequence[dict]) -> Dict[str, int]:
    """Compare every proof of a run.  Each entry: `widx`, `d` (dv, dw,
    dy), `proof` (the eight points, affine, in `PROOF` order), `g1` and
    `g2` (the MSM results the prove produced, affine, in any order) and,
    for sampled proves, `reduction` (`reduction_values` of its outputs).
    -> the counts of proofs checked and of those that disagree, layer by
    layer."""
    out = {"proofs": len(proofs), "failed": 0, "proof_mismatch": 0,
           "msm_mismatch": 0, "reduction_checked": 0,
           "reduction_mismatch": 0}
    for p in proofs:
        exp = ref.msm_points(p["widx"])
        bad = {"msm_mismatch": (
            sorted(map(_key, p["g1"])) != sorted(map(_key, exp["g1"]))
            or sorted(map(_key, p["g2"])) != sorted(map(_key, exp["g2"]))),
            "proof_mismatch": tuple(p["proof"]) != ref.proof_points(
                p["widx"], p["d"])}
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
