"""Pinocchio Protocol 2 (eprint 2013/279): the proof, the verifying key and
the verifier.

The port's own copy of `Proof`, `VKey` and `Pinocchio.verify` of
`zukelang_tpu/protocols/pinocchio.py` (:52-80, :257-282), which mirror
src/pinocchio/pinocchio.ml: an 8-element proof, 4 knowledge-commitment
pairing checks and the divisibility check, through the port's pairing.
An invalid proof returns False.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..golden.curve import G1, G2
from ..pairing import pairing


@dataclass
class VKey:
    """pinocchio.ml:62-75."""
    one: G1
    one2: G2
    av: G2
    aw: G1
    ay: G2
    gm2: G2
    bgm: G1
    bgm2: G2
    yt: G2
    vv_io: Dict
    ww_io: Dict
    yy_io: Dict


@dataclass
class Proof:
    """pinocchio.ml:195-208."""
    vv: G1
    ww: G2
    yy: G1
    h: G1
    vavv: G1
    waww: G2
    yayy: G1
    bvwy: G1


PROOF_FIELDS = ("vv", "ww", "yy", "h", "vavv", "waww", "yayy", "bvwy")


def verify(public: Dict, vkey: VKey, proof: Proof) -> bool:
    """pinocchio.ml:252-421.  `public` maps each io variable to its value."""
    e = pairing
    if set(public.keys()) != set(vkey.vv_io.keys()):
        return False

    # knowledge-commitment checks (pinocchio.ml:285-366)
    if e(proof.vv, vkey.av) != e(proof.vavv, vkey.one2):
        return False
    if e(vkey.aw, proof.ww) != e(vkey.one, proof.waww):
        return False
    if e(proof.yy, vkey.ay) != e(proof.yayy, vkey.one2):
        return False
    if (e(proof.bvwy, vkey.gm2)
            != e(proof.vv, vkey.bgm2) + e(vkey.bgm, proof.ww)
            + e(proof.yy, vkey.bgm2)):
        return False

    ios = sorted(public.keys())
    cio = [public[k] for k in ios]
    vio = G1.dot([vkey.vv_io[k] for k in ios], cio)
    wio = G2.dot([vkey.ww_io[k] for k in ios], cio)
    yio = G1.dot([vkey.yy_io[k] for k in ios], cio)

    # divisibility: e(v_io+v_mid, w_io+w_mid) / e(y_io+y_mid, 1) = e(h, g_y^t)
    lhs = e(vio + proof.vv, wio + proof.ww) - e(yio + proof.yy, vkey.one2)
    return lhs == e(proof.h, vkey.yt)
