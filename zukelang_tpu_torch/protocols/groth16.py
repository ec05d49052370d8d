"""Groth16 (eprint 2016/260) keygen / prove / verify.

Mirrors src/groth16/groth16.ml: 3-element proof {a: G1, b: G2, c: G1},
single verification equation e(A,B) = e(alpha,beta) * e(sum w L/gamma, gamma)
* e(C,delta).  Trapdoor scalars are drawn in source order (alpha, beta,
gamma, delta, tau; then r, s for proving) so an InjectedRng reproduces CRS
and proof bytes exactly (SURVEY.md section 4).

All heavy algebra is delegated to an Engine (MSM, powers, QAP evaluation):
by default a `TorchEngine` on the card.  The port's own copy of
`zukelang_tpu/protocols/groth16.py`; its `Proof` is also the device
path's (`groth16_device`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core import poly
from ..core.circuit import Circuit
from ..core.qap import QAP
from ..core.var import Var
from ..engine.base import Engine
from ..engine.torch_engine import TorchEngine
from ..golden.curve import G1, G2, GT
from ..golden.field import Fr
from ..pairing import pairing


@dataclass
class PKey:
    """groth16.ml:24-34 field-for-field."""
    a: G1                       # alpha
    d1: G1                      # delta
    ti1: List[G1]               # {tau^i} in G1
    ltd_mid: Dict[Var, G1]      # {L_k(tau)/delta} for mids
    tiztd: List[G1]             # {tau^i Z(tau)/delta}, i in 0..n-2
    b1: G1                      # beta in G1
    b2: G2                      # beta in G2
    d2: G2                      # delta in G2
    ti2: List[G2]               # {tau^i} in G2


@dataclass
class VKey:
    """groth16.ml:36-43; alpha_g1/beta_g2 are extensions beyond the
    reference schema (kept out of the interop JSON) enabling batch
    verification (protocols.batch), which needs alpha and beta as points
    rather than only the precomputed e(alpha, beta)."""
    one1: G1
    ltgm_io: Dict[Var, G1]      # {L_k(tau)/gamma} for ios
    one2: G2
    gm: G2
    d: G2
    ab: GT                      # e(alpha, beta)
    alpha_g1: Optional[G1] = None
    beta_g2: Optional[G2] = None


@dataclass
class Proof:
    """groth16.ml:110-114: A in G1, B in G2, C in G1."""
    a: G1
    b: G2
    c: G1


class Groth16:
    name = "groth16"

    def __init__(self, engine: Engine = None):
        self.eng = engine if engine is not None else TorchEngine()

    # -- keygen (groth16.ml:45-108, 227-233) -------------------------------
    def keygen(self, rng, circuit: Circuit, qap: QAP):
        eng = self.eng
        v_io = circuit.inputs_public | circuit.outputs
        v_mid = circuit.mids
        n = poly.degree(qap.target)

        alpha = rng.fr()
        beta = rng.fr()
        gamma = rng.fr()
        delta = rng.fr()
        tau = rng.fr()

        # L_i(x) = beta*A_i(x) + alpha*B_i(x) + C_i(x), evaluated at tau.
        # (groth16.ml:59-68 keeps polynomials; evaluating at tau directly is
        # equivalent and is what the batched engines want.)
        v_at, w_at, y_at = eng.qap_eval_at(qap, tau)
        l_at_tau: Dict[Var, Fr] = {
            k: beta * v_at[k] + alpha * w_at[k] + y_at[k] for k in v_at}

        dinv = delta.inv()
        ginv = gamma.inv()
        z_tau = poly.apply(qap.target, tau)

        mids_sorted = sorted(v_mid)
        ios_sorted = sorted(v_io)
        ltd_mid_scalars = [l_at_tau[k] * dinv for k in mids_sorted]
        ltgm_io_scalars = [l_at_tau[k] * ginv for k in ios_sorted]

        # {tau^i * Z(tau)/delta} for i in 0..n-2
        ztd = z_tau * dinv
        tizd_scalars: List[Fr] = []
        acc = ztd
        for _ in range(max(0, n - 1)):
            tizd_scalars.append(acc)
            acc = acc * tau

        ti1 = eng.g1_powers(n + 1, tau)
        ti2 = eng.g2_powers(n + 1, tau)
        base_g1 = eng.g1_of_fr_batch(
            [alpha, delta, beta] + ltd_mid_scalars + tizd_scalars + ltgm_io_scalars)
        base_g2 = eng.g2_of_fr_batch([beta, delta, gamma])

        i = 3
        ltd_mid = dict(zip(mids_sorted, base_g1[i:i + len(mids_sorted)]))
        i += len(mids_sorted)
        tiztd = base_g1[i:i + len(tizd_scalars)]
        i += len(tizd_scalars)
        ltgm_io = dict(zip(ios_sorted, base_g1[i:i + len(ios_sorted)]))

        pkey = PKey(a=base_g1[0], d1=base_g1[1], ti1=ti1, ltd_mid=ltd_mid,
                    tiztd=tiztd, b1=base_g1[2], b2=base_g2[0], d2=base_g2[1],
                    ti2=ti2)
        vkey = VKey(one1=G1.generator(), ltgm_io=ltgm_io, one2=G2.generator(),
                    gm=base_g2[2], d=base_g2[1],
                    ab=pairing(base_g1[0], base_g2[0]),
                    alpha_g1=base_g1[0], beta_g2=base_g2[0])
        return pkey, vkey

    # -- prove (groth16.ml:116-161, 235-237) -------------------------------
    def prove(self, rng, qap: QAP, pkey: PKey, sol: Dict[Var, Fr]) -> Proof:
        eng = self.eng
        # One witness reduction provides the combined polynomials
        # A = sum w_k A_k, B = sum w_k B_k and the quotient h — equivalent
        # to the per-variable sum_apply_powers folds of groth16.ml:116-121
        # by bilinearity, but one NTT pipeline on the device engine.
        a_comb, b_comb, h = eng.qap_witness_reduction(qap, sol)
        r = rng.fr()
        s = rng.fr()

        a = pkey.a + eng.g1_apply_powers(a_comb, pkey.ti1) + pkey.d1 * r
        b = pkey.b2 + eng.g2_apply_powers(b_comb, pkey.ti2) + pkey.d2 * s
        b1 = pkey.b1 + eng.g1_apply_powers(b_comb, pkey.ti1) + pkey.d1 * s
        htztd = eng.g1_apply_powers(h, pkey.tiztd)
        mids_sorted = sorted(pkey.ltd_mid.keys())
        c_mid = eng.g1_dot([pkey.ltd_mid[k] for k in mids_sorted],
                           [sol[k] for k in mids_sorted])
        c = c_mid + htztd + a * s + b1 * r - pkey.d1 * (r * s)
        return Proof(a=a, b=b, c=c)

    # -- verify (groth16.ml:163-174, 239-240) ------------------------------
    def verify(self, public: Dict[Var, Fr], vkey: VKey, proof: Proof) -> bool:
        io_sorted = sorted(vkey.ltgm_io.keys())
        if set(public.keys()) != set(io_sorted):
            return False
        lio = G1.dot([vkey.ltgm_io[k] for k in io_sorted],
                     [public[k] for k in io_sorted])
        lhs = pairing(proof.a, proof.b)
        rhs = vkey.ab + pairing(lio, vkey.gm) + pairing(proof.c, vkey.d)
        return lhs == rhs
