"""The port's frozen x^3 + x + 3 vectors (zukelang_tpu_torch/testdata/
cubic_ntt.json) against the JAX package: the file is rebuilt from the JAX
package's compiler, flattening and golden Groth16 / Pinocchio (NonZK and
ZK) under the injected scalars, and must be equal to it; the port's
reader must give back the JAX package's flat arrays.

Regenerate the file (after a deliberate change of the reference):
    JAX_PLATFORMS=cpu python tests/test_torch_vectors.py

Tolerance: exact (ints, column indices, proof bytes)."""

import json
import sys

import numpy as np

from zukelang_tpu import params
from zukelang_tpu.core import comp, flat as jflat, lang as L, qap as qap_mod
from zukelang_tpu.golden.field import Fr
from zukelang_tpu.protocols.groth16 import Groth16
from zukelang_tpu.protocols.pinocchio import Pinocchio
from zukelang_tpu.rng import Gen, InjectedRng
from zukelang_tpu_torch import vectors

from jax_flat import assert_side_matches_jax

SCALARS = {
    "groth16_keygen": [i + 1000 for i in range(5)],
    "groth16_prove": [77, 88],
    "pinocchio_keygen": [i + 2000 for i in range(8)],
    "pinocchio_prove": [71, 72, 73],
}


def _instance():
    e = L.let_(L.input("input", L.SECRET, L.ty_field),
               lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))
    c = comp.compile_expr(e)
    q = qap_mod.build(c.gates, domain="ntt")
    _i, _env_lang, env_code = comp.gen_inputs(c.inputs, Gen(3))
    return c, q, comp.code_eval_list(env_code, c.codes)


def _coef_ints(coef16: np.ndarray) -> list:
    """JAX (16, G, K) 16-bit Montgomery limbs -> (G, K) standard ints."""
    limbs = coef16.astype(object)
    vals = sum(limbs[i] << (16 * i) for i in range(limbs.shape[0]))
    rinv = pow(1 << 256, -1, params.R)
    return [[str(int(v) * rinv % params.R) for v in row] for row in vals]


def build_vectors() -> dict:
    c, q, sol = _instance()
    fc = jflat.flatten(c.gates)
    col = fc.var_index
    ios = c.circuit.inputs_public | c.circuit.outputs

    def rng(use):
        return InjectedRng([Fr(x) for x in SCALARS[use]])

    proofs = {}
    g16 = Groth16()
    pk, _ = g16.keygen(rng("groth16_keygen"), c.circuit, q)
    proof = g16.prove(rng("groth16_prove"), q, pk, sol)
    proofs["groth16"] = vectors.proof_hex(proof, "groth16")
    for name, zk in (("pinocchio", False), ("pinocchio_zk", True)):
        proto = Pinocchio(zk=zk)
        pk, _ = proto.keygen(rng("pinocchio_keygen"), c.circuit, q)
        proof = proto.prove(rng("pinocchio_prove"), q, pk, sol)
        proofs[name] = vectors.proof_hex(proof, name)
    return {
        "circuit": "x^3 + x + 3 (let input = secret in input*input*input "
                   "+ input + 3), NTT domain; witness from Gen(3)",
        "n_vars": len(fc.vars_sorted),
        "logn": fc.logn,
        "sides": {name: {"idx": getattr(fc, name).idx.tolist(),
                         "coef": _coef_ints(getattr(fc, name).coef)}
                  for name in ("l", "r", "lhs")},
        "mids": sorted(col[v] for v in c.circuit.mids),
        "ios": sorted(col[v] for v in ios),
        "witness": [str(sol[v].n) for v in fc.vars_sorted],
        "scalars": {k: [str(x) for x in v] for k, v in SCALARS.items()},
        "proofs": proofs,
    }


def test_vectors_file_equals_the_jax_reference():
    with open(vectors.PATH) as f:
        assert json.load(f) == build_vectors()


def test_vectors_reader_gives_the_jax_flat_circuit():
    c, _q, sol = _instance()
    jfc = jflat.flatten(c.gates)
    vec = vectors.load()
    assert vec.fc.logn == jfc.logn and vec.fc.n_gates == jfc.n_gates
    assert len(vec.fc.vars_sorted) == len(jfc.vars_sorted)
    for name in ("l", "r", "lhs"):
        assert_side_matches_jax(getattr(jfc, name), getattr(vec.fc, name),
                                len(jfc.vars_sorted))
    assert vec.witness == [sol[v].n for v in jfc.vars_sorted]
    assert set(vec.proofs) == set(vectors.PROTOCOLS)


if __name__ == "__main__":
    with open(vectors.PATH, "w") as f:
        json.dump(build_vectors(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {vectors.PATH}", file=sys.stderr)
