"""`TorchEngine` on the card against the port's `GoldenEngine`: the
twins of tests/test_torch_engine.py and tests/test_torch_protocols*.py
where they are cheap there (dots, powers, fixed-base batches, the
witness reduction and the evaluation at a point, `tree_sum`, and
Groth16 / Pinocchio proofs of suite programs byte-equal to the golden
engine's under the same injected scalars), at the card's default
windows.

Marked `gpu`: without a CUDA device every test skips (the decision is
made inside the fixture, never at import).  The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_engine_gpu.py -q

Tolerance: exact (compressed point bytes, field elements by their ints)."""

import random

import pytest
import torch

from zukelang_tpu_torch import params
from zukelang_tpu_torch.core import comp, poly, qap as qap_mod
from zukelang_tpu_torch.engine.base import GoldenEngine
from zukelang_tpu_torch.engine.torch_engine import TorchEngine
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.protocols.groth16 import Groth16
from zukelang_tpu_torch.protocols.pinocchio import Pinocchio
from zukelang_tpu_torch.rng import Gen, InjectedRng
from zukelang_tpu_torch.testing.suites import SUITE

pytestmark = pytest.mark.gpu

GROUPS = {"g1": G1, "g2": G2}


@pytest.fixture(scope="module")
def eng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TorchEngine()


def _b(points):
    return [p.to_compressed_bytes() for p in points]


def _points(group, n, rng):
    g = GROUPS[group].generator()
    return [GROUPS[group].zero() if i % 7 == 3 else g * rng.randrange(1, 1 << 64)
            for i in range(n)]


def _scalars(n, rng):
    return [Fr(0 if i % 5 == 2 else rng.randrange(params.R)) for i in range(n)]


@pytest.mark.parametrize("group,n", [("g1", 1), ("g1", 100), ("g2", 15),
                                     ("g2", 100)])
def test_dot(eng, group, n):
    rng = random.Random(n)
    pts, scs = _points(group, n, rng), _scalars(n, rng)
    dot = eng.g1_dot if group == "g1" else eng.g2_dot
    assert _b([dot(pts, scs)]) == _b([GROUPS[group].dot(pts, scs)])


@pytest.mark.parametrize("group,n", [("g1", 3), ("g1", 130), ("g2", 17)])
def test_powers_and_fixed_base(eng, group, n):
    rng = random.Random(n)
    scs = _scalars(n, rng)
    batch = eng.g1_of_fr_batch if group == "g1" else eng.g2_of_fr_batch
    assert _b(batch(scs)) == _b([GROUPS[group].of_Fr(s) for s in scs])
    powers = eng.g1_powers if group == "g1" else eng.g2_powers
    assert _b(powers(n, scs[1])) == _b(GROUPS[group].powers(n, scs[1]))


def _instance(name, seed=4):
    c = comp.compile_expr(dict(SUITE)[name]())
    q = qap_mod.build(c.gates, domain="ntt")
    _i, _l, env = comp.gen_inputs(c.inputs, Gen(seed))
    return c, q, comp.code_eval_list(env, c.codes)


def test_qap_algebra(eng):
    _c, q, sol = _instance("case")
    got = eng.qap_witness_reduction(q, sol)
    want = GoldenEngine().qap_witness_reduction(q, sol)
    assert all(poly.equal(a, b) for a, b in zip(got, want))
    x = Fr(987654321)
    assert eng.qap_eval_at(q, x) == GoldenEngine().qap_eval_at(q, x)


def test_tree_sum(eng):
    pts = _points("g2", 5, random.Random(5))
    got = C.unpack_g2(C.tree_sum(C.pack_g2(pts, eng.device)))
    want = G2.zero()
    for p in pts:
        want = want + p
    assert _b(got) == _b([want])


@pytest.mark.parametrize("name", ["cubic", "case", "uint32_sub"])
def test_protocols_equal_golden_engine(eng, name):
    c, q, sol = _instance(name)
    public = {v: f for v, f in sol.items() if v not in c.circuit.mids}
    for mk, nkey, nprove in ((lambda e: Groth16(e), 5, 2),
                             (lambda e: Pinocchio(e, zk=False), 8, 3),
                             (lambda e: Pinocchio(e, zk=True), 8, 3)):
        proofs = []
        for engine in (eng, GoldenEngine()):
            proto = mk(engine)
            pk, vk = proto.keygen(InjectedRng([Fr(i + 9) for i in range(nkey)]),
                                  c.circuit, q)
            proof = proto.prove(InjectedRng([Fr(i + 3) for i in range(nprove)]),
                                q, pk, sol)
            assert proto.verify(public, vk, proof)
            proofs.append(_b(list(vars(proof).values())))
        assert proofs[0] == proofs[1]


def test_frozen_vectors_through_the_engine_protocols(eng):
    from zukelang_tpu_torch import vectors
    vec = vectors.load()
    res = vectors.engine_prove_all(vec)
    assert {k: v for k, (v, _ok) in res.items()} == vec.proofs
    assert all(ok for _v, ok in res.values())
