"""The port's Groth16 over `TorchEngine` (on the CPU: the kernels' plain
versions) against the JAX package's golden Groth16: each of the
reference suite's 13 programs through both packages' `run_pipeline` on
the NTT domain under the same injected scalars, with the keys' JSON
documents and the proof bytes equal; the JAX keys carried into the port
by JSON; a tampered public input rejected; batch verification as in the
JAX package.  Windows pinned small (MSM c = 4, fixed base c = 4).
Tolerance: exact (JSON documents, compressed point bytes)."""

import pytest
import torch

from zukelang_tpu import serialize as jS
from zukelang_tpu.golden.field import Fr as JFr
from zukelang_tpu.protocols import batch as jbatch
from zukelang_tpu.protocols.groth16 import Groth16 as JGroth16
from zukelang_tpu.rng import Gen as JGen, InjectedRng as JInjectedRng
from zukelang_tpu.testing.harness import run_pipeline as jrun_pipeline
from zukelang_tpu_torch import serialize as S
from zukelang_tpu_torch.engine.base import GoldenEngine
from zukelang_tpu_torch.engine.torch_engine import TorchEngine
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.protocols import batch
from zukelang_tpu_torch.protocols.groth16 import Groth16
from zukelang_tpu_torch.rng import Gen, InjectedRng
from zukelang_tpu_torch.testing.harness import run_pipeline

from test_torch_core import (SUITE_NAMES, both_programs, same_counters,
                             small_windows)  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("small_windows")

KEY = [1000 + i for i in range(5)]        # alpha, beta, gamma, delta, tau
PROVE = [77, 88]                          # r, s


def engine():
    return TorchEngine(device="cpu")


def run_both(name, proto, jproto, key, prove, seed=0):
    """One suite program through both packages' pipelines (ntt domain,
    injected scalars), each from the same Var counter value."""
    je, te = both_programs(name)
    with same_counters(100):
        jres = jrun_pipeline(je, jproto, seed=seed, domain="ntt",
                             keygen_rng=JInjectedRng([JFr(k) for k in key]),
                             prove_rng=JInjectedRng([JFr(k) for k in prove]))
    with same_counters(100):
        res = run_pipeline(te, proto, seed=seed, domain="ntt",
                           keygen_rng=InjectedRng([Fr(k) for k in key]),
                           prove_rng=InjectedRng([Fr(k) for k in prove]))
    return res, jres


def _json(doc):
    return S.dumps(doc)


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_groth16_over_torch_engine_equals_jax_golden(name):
    res, jres = run_both(name, Groth16(engine()), JGroth16(), KEY, PROVE)
    assert res.verified and jres.verified
    assert _json(S.groth16_pkey_to_json(res.pkey)) == _json(
        jS.groth16_pkey_to_json(jres.pkey))
    assert _json(S.groth16_vkey_to_json(res.vkey)) == _json(
        jS.groth16_vkey_to_json(jres.vkey))
    assert _json(S.groth16_proof_to_json(res.proof)) == _json(
        jS.groth16_proof_to_json(jres.proof))
    assert _json(S.var_map_to_json(res.public, S.fr_to_json)) == _json(
        jS.var_map_to_json(jres.public, jS.fr_to_json))


@pytest.fixture(scope="module")
def golden_cubic():
    """x^3 + x + 3 through both packages over golden engines (fast): the
    JAX keypair and proof, and the port's run."""
    return run_both("cubic", Groth16(GoldenEngine()), JGroth16(), KEY, PROVE)


def test_jax_keys_carried_by_json_verify_and_reserialize(golden_cubic):
    res, jres = golden_cubic
    pk = S.groth16_pkey_of_json(jS.groth16_pkey_to_json(jres.pkey))
    vk = S.groth16_vkey_of_json(jS.groth16_vkey_to_json(jres.vkey))
    proof = S.groth16_proof_of_json(jS.groth16_proof_to_json(jres.proof))
    assert _json(S.groth16_pkey_to_json(pk)) == _json(
        jS.groth16_pkey_to_json(jres.pkey))
    public = S.var_map_of_json(jS.var_map_to_json(jres.public, jS.fr_to_json),
                               S.fr_of_json)
    proto = Groth16(GoldenEngine())
    assert proto.verify(public, vk, proof)
    # and the port's proof with the carried key equals the JAX proof
    again = proto.prove(InjectedRng([Fr(k) for k in PROVE]), res.qap, pk,
                        res.sol)
    assert _json(S.groth16_proof_to_json(again)) == _json(
        jS.groth16_proof_to_json(jres.proof))


def test_tampered_public_input_rejected(golden_cubic):
    res, _jres = golden_cubic
    proto = Groth16(GoldenEngine())
    bad = dict(res.public)
    k = next(iter(bad))
    bad[k] = bad[k] + Fr(1)
    assert not proto.verify(bad, res.vkey, res.proof)
    assert not proto.verify({}, res.vkey, res.proof)


def test_batch_verify_matches_jax(golden_cubic):
    """Two proofs of one statement and a third of a tampered statement:
    the port's batch verifier agrees with the JAX package's."""
    res, jres = golden_cubic
    proto, jproto = Groth16(GoldenEngine()), JGroth16()
    proofs = batch.prove_many(proto, Gen(5), res.qap, res.pkey,
                              [res.sol, res.sol])
    jproofs = jbatch.prove_many(jproto, JGen(5), jres.qap, jres.pkey,
                                [jres.sol, jres.sol])
    assert [_json(S.groth16_proof_to_json(p)) for p in proofs] == [
        _json(jS.groth16_proof_to_json(p)) for p in jproofs]
    stmts = [(res.public, p) for p in proofs]
    jstmts = [(jres.public, p) for p in jproofs]
    assert batch.batch_verify_groth16(res.vkey, stmts)
    assert jbatch.batch_verify_groth16(jres.vkey, jstmts)
    bad = dict(res.public)
    k = next(iter(bad))
    bad[k] = bad[k] + Fr(1)
    assert not batch.batch_verify_groth16(res.vkey, stmts + [(bad,
                                                              proofs[0])])
    t, jt = batch.Transcript(), jbatch.Transcript()
    for tr in (t, jt):
        tr.absorb(b"x", b"abc")
    t.absorb_point(b"p", res.proof.a)
    jt.absorb_point(b"p", jres.proof.a)
    assert t.challenge_fr(b"c").n == jt.challenge_fr(b"c").n
