"""The port's Pinocchio (NonZK and ZK) over `TorchEngine` (on the CPU:
the kernels' plain versions) against the JAX package's golden Pinocchio,
on x^3 + x + 3 and the suite's two compound programs (compound output,
compound input): the same keys (their JSON documents equal), the JAX
keys carried into the port by JSON, and with them the port's NonZK and
ZK proofs byte-equal to the JAX proofs under the same injected scalars;
each proof verifies, and a tampered public input is rejected.  A file of
its own so that the test workers run it beside the Groth16 suite.
Windows pinned small (MSM c = 4, fixed base c = 4).  Tolerance: exact."""

import pytest
import torch

from zukelang_tpu import serialize as jS
from zukelang_tpu.core import comp as jcomp, qap as jqap
from zukelang_tpu.golden.field import Fr as JFr
from zukelang_tpu.protocols.pinocchio import Pinocchio as JPinocchio
from zukelang_tpu.rng import Gen as JGen, InjectedRng as JInjectedRng
from zukelang_tpu_torch import serialize as S
from zukelang_tpu_torch.core import comp, qap as qap_mod
from zukelang_tpu_torch.engine.torch_engine import TorchEngine
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.protocols.pinocchio import Pinocchio
from zukelang_tpu_torch.rng import Gen, InjectedRng

from test_torch_core import (both_programs, compile_both, plain,
                             small_windows)  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("small_windows")

KEY = [2000 + i for i in range(8)]     # rv, rw, s, av, aw, ay, b, gm
PROVE = [31, 32, 33]                   # dv, dw, dy (ZK)


def _json(doc):
    return S.dumps(doc)


@pytest.mark.parametrize("name", ["cubic", "compound_output",
                                  "compound_input"])
def test_pinocchio_over_torch_engine_equals_jax_golden(name):
    jc, tc = compile_both(*both_programs(name))
    jq = jqap.build(jc.gates, domain="ntt")
    q = qap_mod.build(tc.gates, domain="ntt")
    _i, _l, jenv = jcomp.gen_inputs(jc.inputs, JGen(3))
    _i, _l, env = comp.gen_inputs(tc.inputs, Gen(3))
    jsol = jcomp.code_eval_list(jenv, jc.codes)
    sol = comp.code_eval_list(env, tc.codes)
    assert plain(sol) == plain(jsol)
    public = {v: f for v, f in sol.items() if v not in tc.circuit.mids}

    eng = TorchEngine(device="cpu")
    jproto = JPinocchio(zk=False)
    jpk, jvk = jproto.keygen(JInjectedRng([JFr(k) for k in KEY]), jc.circuit,
                             jq)
    pk, vk = Pinocchio(eng, zk=False).keygen(
        InjectedRng([Fr(k) for k in KEY]), tc.circuit, q)
    assert _json(S.pinocchio_pkey_to_json(pk)) == _json(
        jS.pinocchio_pkey_to_json(jpk))
    assert _json(S.pinocchio_vkey_to_json(vk)) == _json(
        jS.pinocchio_vkey_to_json(jvk))
    carried = S.pinocchio_pkey_of_json(jS.pinocchio_pkey_to_json(jpk))
    for zk in (False, True):
        jproof = JPinocchio(zk=zk).prove(
            JInjectedRng([JFr(k) for k in PROVE]), jq, jpk, jsol)
        proto = Pinocchio(eng, zk=zk)
        proof = proto.prove(InjectedRng([Fr(k) for k in PROVE]), q, carried,
                            sol)
        assert _json(S.pinocchio_proof_to_json(proof)) == _json(
            jS.pinocchio_proof_to_json(jproof))
        assert proto.verify(public, vk, proof)
    bad = dict(public)
    k = next(iter(bad))
    bad[k] = bad[k] + Fr(1)
    assert not proto.verify(bad, vk, proof)
