"""The frozen x^3 + x + 3 vectors: `testdata/cubic_ntt.json`.

The circuit of the JAX package's device tests (`x^3 + x + 3` over the
NTT domain), flattened into plain arrays, with its witness, the injected
trapdoor and blinding scalars, and the golden proof bytes of Groth16,
Pinocchio NonZK and Pinocchio ZK under those scalars.
tests/test_torch_vectors.py rebuilds the file from the JAX package's
compiler and golden protocols and fails if it differs, so it cannot drift
from the reference; the port and `chip_smoke.py` read only the file.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

from .core import flat
from .golden.field import Fr
from .protocols import groth16_device as gd
from .protocols import pinocchio_device as pd
from .protocols.pinocchio import PROOF_FIELDS
from .rng import InjectedRng

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata",
                    "cubic_ntt.json")
PROTOCOLS = ("groth16", "pinocchio", "pinocchio_zk")
PARTS = {"groth16": ("a", "b", "c"), "pinocchio": PROOF_FIELDS,
         "pinocchio_zk": PROOF_FIELDS}


@dataclass
class Vectors:
    fc: flat.FlatCircuit
    mids: List[int]                  # witness columns
    ios: List[int]
    witness: List[int]               # values by column
    scalars: Dict[str, List[Fr]]     # rng streams by use
    proofs: Dict[str, Dict[str, str]]  # protocol -> part -> hex bytes

    def public(self) -> Dict[int, Fr]:
        return {c: Fr(self.witness[c]) for c in self.ios}


def load(path: str = PATH) -> Vectors:
    with open(path) as f:
        j = json.load(f)
    sides = {k: (v["idx"], [[int(x) for x in row] for row in v["coef"]])
             for k, v in j["sides"].items()}
    fc = flat.from_arrays(j["n_vars"], j["logn"], l=sides["l"], r=sides["r"],
                          lhs=sides["lhs"])
    return Vectors(
        fc=fc, mids=j["mids"], ios=j["ios"],
        witness=[int(x) for x in j["witness"]],
        scalars={k: [Fr(int(x)) for x in v] for k, v in j["scalars"].items()},
        proofs=j["proofs"])


def proof_hex(proof, protocol: str) -> Dict[str, str]:
    return {p: getattr(proof, p).to_compressed_bytes().hex()
            for p in PARTS[protocol]}


def prove_all(vec: Vectors, device=None) -> Dict[str, tuple]:
    """Keygen, prove and verify of every protocol on the vectors through
    the port, on `device` (default: the card).  Returns protocol ->
    (proof bytes as `proof_hex`, verified)."""
    fc, wm = vec.fc, flat.pack_witness_values(vec.witness, gd._device(device))

    def rng(use):
        return InjectedRng(vec.scalars[use])

    out = {}
    crs, gvk = gd.keygen_device(fc, vec.mids, vec.ios, rng("groth16_keygen"),
                                device)
    proof = gd.prove_device(crs, fc, wm, rng("groth16_prove"))
    out["groth16"] = (proof_hex(proof, "groth16"),
                      gd.verify(vec.public(), gvk, proof))
    pk, pvk = pd.keygen_device(fc, vec.mids, vec.ios, rng("pinocchio_keygen"),
                               device)
    for name, zk in (("pinocchio", False), ("pinocchio_zk", True)):
        proof = pd.prove_device(pk, fc, wm, rng("pinocchio_prove"), zk=zk)
        out[name] = (proof_hex(proof, name), pd.verify(vec.public(), pvk, proof))
    return out
