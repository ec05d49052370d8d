"""JSON serialization for keys and proofs, in the reference's schema.

The port's own copy of `zukelang_tpu/serialize.py`, so a document or
keypair file written by either package reads back in the other.  The
reference derives yojson serializers for every pkey/vkey/proof
(protocol.ml:10-14; pinocchio.ml:37-75, :195-208; groth16.ml:24-43,
:110-114) with:
  * Fr as a decimal string (via Z; curve.ml:139-140, misc.ml:36-38),
  * G1/G2 as compressed bytes per the ZCash spec (curve.ml:199-210) —
    rendered here as lowercase hex strings,
  * GT as uncompressed bytes (curve.ml:217-219),
  * Var as [name, serial] pairs (var.ml:4-6),
  * Var.Map as sorted [[var, value], ...] binding lists (var.ml:66-68).

Field names match the reference records.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .core.var import Var
from .golden.curve import G1, G2, GT
from .golden.field import Fr


# -- scalars / points --------------------------------------------------------

def fr_to_json(f: Fr):
    return str(f.n)


def fr_of_json(j) -> Fr:
    return Fr(int(j))


def g1_to_json(p: G1):
    return p.to_compressed_bytes().hex()


def g1_of_json(j) -> G1:
    return G1.of_compressed_bytes(bytes.fromhex(j))


def g2_to_json(p: G2):
    return p.to_compressed_bytes().hex()


def g2_of_json(j) -> G2:
    return G2.of_compressed_bytes(bytes.fromhex(j))


def gt_to_json(p: GT):
    return p.to_bytes().hex()


def gt_of_json(j) -> GT:
    return GT.of_bytes(bytes.fromhex(j))


def var_to_json(v: Var):
    return [v.name, v.id]


def var_of_json(j) -> Var:
    return Var(j[0], int(j[1]))


def var_map_to_json(m: Dict[Var, Any], conv):
    return [[var_to_json(v), conv(m[v])] for v in sorted(m)]


def var_map_of_json(j, conv) -> Dict[Var, Any]:
    return {var_of_json(vj): conv(xj) for vj, xj in j}


# -- Lang values -------------------------------------------------------------

def value_to_json(v):
    """Typed DSL value (lang.ml:254-306) as a [tag, args...] list:
    ["field", "<dec>"], ["bool", b], ["uint32", n],
    ["pair", a, b], ["left", a], ["right", b]."""
    t = v.tag
    if t == "field":
        return [t, fr_to_json(v.args[0])]
    if t in ("bool", "uint32"):
        return [t, v.args[0]]
    if t == "pair":
        return [t, value_to_json(v.args[0]), value_to_json(v.args[1])]
    if t in ("left", "right"):
        return [t, value_to_json(v.args[0])]
    raise ValueError(f"unknown value tag {t!r}")


def value_of_json(j):
    from .core import lang as L
    t = j[0]
    if t == "field":
        return L.v_field(fr_of_json(j[1]))
    if t == "bool":
        return L.v_bool(j[1])
    if t == "uint32":
        return L.v_uint32(j[1])
    if t == "pair":
        return L.v_pair(value_of_json(j[1]), value_of_json(j[2]))
    if t == "left":
        return L.v_left(value_of_json(j[1]))
    if t == "right":
        return L.v_right(value_of_json(j[1]))
    raise ValueError(f"unknown value tag {t!r}")


# -- proofs ------------------------------------------------------------------

def groth16_proof_to_json(proof) -> dict:
    # groth16.ml:110-114 field names
    return {"a": g1_to_json(proof.a), "b": g2_to_json(proof.b),
            "c": g1_to_json(proof.c)}


def groth16_proof_of_json(j):
    from .protocols.groth16 import Proof
    return Proof(a=g1_of_json(j["a"]), b=g2_of_json(j["b"]),
                 c=g1_of_json(j["c"]))


def pinocchio_proof_to_json(proof) -> dict:
    # pinocchio.ml:195-208 field names
    return {
        "vv": g1_to_json(proof.vv), "ww": g2_to_json(proof.ww),
        "yy": g1_to_json(proof.yy), "h": g1_to_json(proof.h),
        "vavv": g1_to_json(proof.vavv), "waww": g2_to_json(proof.waww),
        "yayy": g1_to_json(proof.yayy), "bvwy": g1_to_json(proof.bvwy),
    }


def pinocchio_proof_of_json(j):
    from .protocols.pinocchio import Proof
    return Proof(vv=g1_of_json(j["vv"]), ww=g2_of_json(j["ww"]),
                 yy=g1_of_json(j["yy"]), h=g1_of_json(j["h"]),
                 vavv=g1_of_json(j["vavv"]), waww=g2_of_json(j["waww"]),
                 yayy=g1_of_json(j["yayy"]), bvwy=g1_of_json(j["bvwy"]))


# -- keys --------------------------------------------------------------------

def groth16_pkey_to_json(pk) -> dict:
    # groth16.ml:24-34 field names
    return {
        "a": g1_to_json(pk.a), "d1": g1_to_json(pk.d1),
        "ti1": [g1_to_json(p) for p in pk.ti1],
        "ltd_mid": var_map_to_json(pk.ltd_mid, g1_to_json),
        "tiztd": [g1_to_json(p) for p in pk.tiztd],
        "b1": g1_to_json(pk.b1), "b2": g2_to_json(pk.b2),
        "d2": g2_to_json(pk.d2),
        "ti2": [g2_to_json(p) for p in pk.ti2],
    }


def groth16_pkey_of_json(j):
    from .protocols.groth16 import PKey
    return PKey(
        a=g1_of_json(j["a"]), d1=g1_of_json(j["d1"]),
        ti1=[g1_of_json(x) for x in j["ti1"]],
        ltd_mid=var_map_of_json(j["ltd_mid"], g1_of_json),
        tiztd=[g1_of_json(x) for x in j["tiztd"]],
        b1=g1_of_json(j["b1"]), b2=g2_of_json(j["b2"]),
        d2=g2_of_json(j["d2"]),
        ti2=[g2_of_json(x) for x in j["ti2"]],
    )


def groth16_vkey_to_json(vk) -> dict:
    # groth16.ml:36-43 field names
    return {
        "one1": g1_to_json(vk.one1),
        "ltgm_io": var_map_to_json(vk.ltgm_io, g1_to_json),
        "one2": g2_to_json(vk.one2), "gm": g2_to_json(vk.gm),
        "d": g2_to_json(vk.d), "ab": gt_to_json(vk.ab),
    }


def groth16_vkey_of_json(j):
    from .protocols.groth16 import VKey
    return VKey(
        one1=g1_of_json(j["one1"]),
        ltgm_io=var_map_of_json(j["ltgm_io"], g1_of_json),
        one2=g2_of_json(j["one2"]), gm=g2_of_json(j["gm"]),
        d=g2_of_json(j["d"]), ab=gt_of_json(j["ab"]),
    )


def pinocchio_pkey_to_json(pk) -> dict:
    # pinocchio.ml:37-60 field names
    out = {}
    for name in ("vv", "yy", "vav", "yay", "bvwy", "v_all", "w_all"):
        out[name] = var_map_to_json(getattr(pk, name), g1_to_json)
    for name in ("ww", "waw"):
        out[name] = var_map_to_json(getattr(pk, name), g2_to_json)
    out["si"] = [g1_to_json(p) for p in pk.si]
    out["si2"] = [g2_to_json(p) for p in pk.si2]
    for name in ("vt", "yt", "vavt", "yayt", "vbt", "wbt", "ybt"):
        out[name] = g1_to_json(getattr(pk, name))
    for name in ("wt", "wawt"):
        out[name] = g2_to_json(getattr(pk, name))
    return out


def pinocchio_pkey_of_json(j):
    from .protocols.pinocchio import PKey
    return PKey(
        vv=var_map_of_json(j["vv"], g1_of_json),
        ww=var_map_of_json(j["ww"], g2_of_json),
        yy=var_map_of_json(j["yy"], g1_of_json),
        vav=var_map_of_json(j["vav"], g1_of_json),
        waw=var_map_of_json(j["waw"], g2_of_json),
        yay=var_map_of_json(j["yay"], g1_of_json),
        si=[g1_of_json(x) for x in j["si"]],
        bvwy=var_map_of_json(j["bvwy"], g1_of_json),
        si2=[g2_of_json(x) for x in j["si2"]],
        vt=g1_of_json(j["vt"]), wt=g2_of_json(j["wt"]),
        yt=g1_of_json(j["yt"]), vavt=g1_of_json(j["vavt"]),
        wawt=g2_of_json(j["wawt"]), yayt=g1_of_json(j["yayt"]),
        vbt=g1_of_json(j["vbt"]), wbt=g1_of_json(j["wbt"]),
        ybt=g1_of_json(j["ybt"]),
        v_all=var_map_of_json(j["v_all"], g1_of_json),
        w_all=var_map_of_json(j["w_all"], g1_of_json),
    )


def pinocchio_vkey_to_json(vk) -> dict:
    # pinocchio.ml:62-75 field names
    return {
        "one": g1_to_json(vk.one), "one2": g2_to_json(vk.one2),
        "av": g2_to_json(vk.av), "aw": g1_to_json(vk.aw),
        "ay": g2_to_json(vk.ay), "gm2": g2_to_json(vk.gm2),
        "bgm": g1_to_json(vk.bgm), "bgm2": g2_to_json(vk.bgm2),
        "yt": g2_to_json(vk.yt),
        "vv_io": var_map_to_json(vk.vv_io, g1_to_json),
        "ww_io": var_map_to_json(vk.ww_io, g2_to_json),
        "yy_io": var_map_to_json(vk.yy_io, g1_to_json),
    }


def pinocchio_vkey_of_json(j):
    from .protocols.pinocchio import VKey
    return VKey(
        one=g1_of_json(j["one"]), one2=g2_of_json(j["one2"]),
        av=g2_of_json(j["av"]), aw=g1_of_json(j["aw"]),
        ay=g2_of_json(j["ay"]), gm2=g2_of_json(j["gm2"]),
        bgm=g1_of_json(j["bgm"]), bgm2=g2_of_json(j["bgm2"]),
        yt=g2_of_json(j["yt"]),
        vv_io=var_map_of_json(j["vv_io"], g1_of_json),
        ww_io=var_map_of_json(j["ww_io"], g2_of_json),
        yy_io=var_map_of_json(j["yy_io"], g1_of_json),
    )


VKEY_TO_JSON = {"groth16": groth16_vkey_to_json,
                "pinocchio": pinocchio_vkey_to_json,
                "pinocchio_zk": pinocchio_vkey_to_json}
VKEY_OF_JSON = {"groth16": groth16_vkey_of_json,
                "pinocchio": pinocchio_vkey_of_json,
                "pinocchio_zk": pinocchio_vkey_of_json}
PROOF_TO_JSON = {"groth16": groth16_proof_to_json,
                 "pinocchio": pinocchio_proof_to_json,
                 "pinocchio_zk": pinocchio_proof_to_json}
PROOF_OF_JSON = {"groth16": groth16_proof_of_json,
                 "pinocchio": pinocchio_proof_of_json,
                 "pinocchio_zk": pinocchio_proof_of_json}


def dumps(obj) -> str:
    return json.dumps(obj, separators=(",", ":"), sort_keys=False)
