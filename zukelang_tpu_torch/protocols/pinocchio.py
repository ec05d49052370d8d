"""Pinocchio Protocol 2 (eprint 2013/279), NonZK and ZK variants.

Mirrors src/pinocchio/pinocchio.ml: 8-element proof, 4 knowledge-commitment
pairing checks plus the divisibility check (9 pairings total).  Trapdoor
scalars are drawn in source order (rv, rw, s, alpha_v, alpha_w, alpha_y,
beta, gamma; ZK prove adds dv, dw, dy) for injectable reproducibility.

One API divergence: invalid proofs return False from verify instead of
crashing (the reference uses bare `assert`, pinocchio.ml:285-366).

The port's own copy of `zukelang_tpu/protocols/pinocchio.py`, over an
Engine (by default a `TorchEngine` on the card).  `Proof`, `VKey` and
`verify` are also the device path's (`pinocchio_device`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..core import poly
from ..core.circuit import Circuit
from ..core.qap import QAP
from ..core.var import Var
from ..engine.base import Engine
from ..engine.torch_engine import TorchEngine
from ..golden.curve import G1, G2
from ..golden.field import Fr
from ..pairing import pairing


@dataclass
class PKey:
    """pinocchio.ml:37-60 field-for-field."""
    vv: Dict[Var, G1]       # {g_v^{v_k(s)}}  k in mids
    ww: Dict[Var, G2]       # {g_w^{w_k(s)}}
    yy: Dict[Var, G1]       # {g_y^{y_k(s)}}
    vav: Dict[Var, G1]      # {g_v^{av v_k(s)}}
    waw: Dict[Var, G2]      # {g_w^{aw w_k(s)}}
    yay: Dict[Var, G1]      # {g_y^{ay y_k(s)}}
    si: List[G1]            # {g^{s^i}}
    bvwy: Dict[Var, G1]     # {g_v^{b v_k} g_w^{b w_k} g_y^{b y_k}}
    si2: List[G2]
    vt: G1
    wt: G2
    yt: G1
    vavt: G1
    wawt: G2
    yayt: G1
    vbt: G1
    wbt: G1
    ybt: G1
    v_all: Dict[Var, G1]    # {g_1^{v_k(s)}}  k in all vars
    w_all: Dict[Var, G1]


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
    vv_io: Dict[Var, G1]
    ww_io: Dict[Var, G2]
    yy_io: Dict[Var, G1]


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


def verify(public: Dict[Var, Fr], vkey: VKey, proof: Proof) -> bool:
    """pinocchio.ml:252-421.  `public` maps each io variable to its value."""
    e = pairing
    if set(public.keys()) != set(vkey.vv_io.keys()):
        return False

    # KC checks (pinocchio.ml:285-366)
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


class Pinocchio:
    """NonZK by default; zk=True adds the delta-randomization
    (pinocchio.ml:423-515)."""

    def __init__(self, engine: Engine = None, zk: bool = True):
        self.eng = engine if engine is not None else TorchEngine()
        self.zk = zk
        self.name = "pinocchio_zk" if zk else "pinocchio"

    # -- keygen (pinocchio.ml:77-189) --------------------------------------
    def keygen(self, rng, circuit: Circuit, qap: QAP):
        eng = self.eng
        imid = sorted(circuit.mids)
        nio = sorted(circuit.ios())
        m = sorted(qap.v.keys())
        d = poly.degree(qap.target)

        rv = rng.fr()
        rw = rng.fr()
        s = rng.fr()
        av = rng.fr()
        aw = rng.fr()
        ay = rng.fr()
        b = rng.fr()
        gm = rng.fr()
        ry = rv * rw

        t = poly.apply(qap.target, s)

        # Evaluate every QAP polynomial at s once (batched on the engine).
        v_s, w_s, y_s = eng.qap_eval_at(qap, s)

        # One big fixed-base batch in G1 and one in G2.
        g1_scalars: List[Fr] = []
        g1_slots = []

        def g1p(label, key, scalar):
            g1_slots.append((label, key))
            g1_scalars.append(scalar)

        for k in imid:
            g1p("vv", k, rv * v_s[k])
            g1p("ww1", k, rw * w_s[k])
            g1p("yy", k, ry * y_s[k])
            g1p("vav", k, rv * v_s[k] * av)
            g1p("yay", k, ry * y_s[k] * ay)
            g1p("bvwy", k, (rv * v_s[k] + rw * w_s[k] + ry * y_s[k]) * b)
        for k in m:
            g1p("v_all", k, v_s[k])
            g1p("w_all", k, w_s[k])
        for k in nio:
            g1p("vv_io", k, rv * v_s[k])
            g1p("yy_io", k, ry * y_s[k])
        g1p("vt", None, rv * t)
        g1p("yt", None, ry * t)
        g1p("vavt", None, rv * av * t)
        g1p("yayt", None, ry * ay * t)
        g1p("vbt", None, rv * b * t)
        g1p("wbt", None, rw * b * t)
        g1p("ybt", None, ry * b * t)
        g1p("aw_v", None, aw)
        g1p("bgm", None, gm * b)

        g2_scalars: List[Fr] = []
        g2_slots = []

        def g2p(label, key, scalar):
            g2_slots.append((label, key))
            g2_scalars.append(scalar)

        for k in imid:
            g2p("ww", k, rw * w_s[k])
            g2p("waw", k, rw * w_s[k] * aw)
        for k in nio:
            g2p("ww_io", k, rw * w_s[k])
        g2p("wt", None, rw * t)
        g2p("wawt", None, rw * aw * t)
        g2p("av_v", None, av)
        g2p("ay_v", None, ay)
        g2p("gm2", None, gm)
        g2p("bgm2", None, gm * b)
        g2p("yt2", None, ry * t)

        pts1 = eng.g1_of_fr_batch(g1_scalars)
        pts2 = eng.g2_of_fr_batch(g2_scalars)

        d1: Dict[str, Dict[Var, G1]] = {}
        s1: Dict[str, G1] = {}
        for (label, key), pt in zip(g1_slots, pts1):
            if key is None:
                s1[label] = pt
            else:
                d1.setdefault(label, {})[key] = pt
        d2: Dict[str, Dict[Var, G2]] = {}
        s2: Dict[str, G2] = {}
        for (label, key), pt in zip(g2_slots, pts2):
            if key is None:
                s2[label] = pt
            else:
                d2.setdefault(label, {})[key] = pt

        si = eng.g1_powers(d, s)
        si2 = eng.g2_powers(d, s)

        pkey = PKey(
            vv=d1.get("vv", {}), ww=d2.get("ww", {}), yy=d1.get("yy", {}),
            vav=d1.get("vav", {}), waw=d2.get("waw", {}), yay=d1.get("yay", {}),
            si=si, bvwy=d1.get("bvwy", {}), si2=si2,
            vt=s1["vt"], wt=s2["wt"], yt=s1["yt"],
            vavt=s1["vavt"], wawt=s2["wawt"], yayt=s1["yayt"],
            vbt=s1["vbt"], wbt=s1["wbt"], ybt=s1["ybt"],
            v_all=d1.get("v_all", {}), w_all=d1.get("w_all", {}),
        )
        vkey = VKey(
            one=G1.generator(), one2=G2.generator(),
            av=s2["av_v"], aw=s1["aw_v"], ay=s2["ay_v"],
            gm2=s2["gm2"], bgm=s1["bgm"], bgm2=s2["bgm2"], yt=s2["yt2"],
            vv_io=d1.get("vv_io", {}), ww_io=d2.get("ww_io", {}),
            yy_io=d1.get("yy_io", {}),
        )
        return pkey, vkey

    # -- prove (pinocchio.ml:193-250, 423-515) -----------------------------
    def prove(self, rng, qap: QAP, pkey: PKey, sol: Dict[Var, Fr]) -> Proof:
        eng = self.eng
        _a, _b, h_poly = eng.qap_witness_reduction(qap, sol)

        mids = sorted(pkey.vv.keys())
        c_mid = [sol[k] for k in mids]

        def dot1(mp):
            return eng.g1_dot([mp[k] for k in mids], c_mid)

        def dot2(mp):
            return eng.g2_dot([mp[k] for k in mids], c_mid)

        vv = dot1(pkey.vv)
        ww = dot2(pkey.ww)
        yy = dot1(pkey.yy)
        h = eng.g1_apply_powers(h_poly, pkey.si)
        vavv = dot1(pkey.vav)
        waww = dot2(pkey.waw)
        yayy = dot1(pkey.yay)
        bvwy = dot1(pkey.bvwy)

        if not self.zk:
            return Proof(vv=vv, ww=ww, yy=yy, h=h,
                         vavv=vavv, waww=waww, yayy=yayy, bvwy=bvwy)

        # ZK randomization (pinocchio.ml:427-514)
        dv = rng.fr()
        dw = rng.fr()
        dy = rng.fr()
        t_g1 = eng.g1_apply_powers(qap.target, pkey.si)

        allv = sorted(sol.keys())
        call = [sol[k] for k in allv]
        v_all = eng.g1_dot([pkey.v_all[k] for k in allv], call)
        w_all = eng.g1_dot([pkey.w_all[k] for k in allv], call)

        # h' = h + v(s)*dw + w(s)*dv + dv*dw*t(s) - dy   (in G1 exponent)
        h2 = h + v_all * dw + w_all * dv + t_g1 * (dv * dw) - G1.generator() * dy

        return Proof(
            vv=vv + pkey.vt * dv,
            ww=ww + pkey.wt * dw,
            yy=yy + pkey.yt * dy,
            h=h2,
            vavv=vavv + pkey.vavt * dv,
            waww=waww + pkey.wawt * dw,
            yayy=yayy + pkey.yayt * dy,
            bvwy=bvwy + pkey.vbt * dv + pkey.wbt * dw + pkey.ybt * dy,
        )

    # -- verify (pinocchio.ml:252-421) -------------------------------------
    def verify(self, public: Dict[Var, Fr], vkey: VKey, proof: Proof) -> bool:
        return verify(public, vkey, proof)
