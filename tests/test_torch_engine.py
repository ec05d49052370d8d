"""`TorchEngine` on the CPU (the kernels' plain versions) against the
port's `GoldenEngine` and the JAX package's `JaxEngine`: dots at several
widths with infinity points and zero scalars, powers, fixed-base batches
(both the K3 chain below 128 elements and the K5 rows from 128), the
witness reduction and the evaluation at a point on the NTT domain, the
reference-domain fallback, `tree_sum`, and the refusal of the card's
default without CUDA.  Windows are pinned small (MSM c = 4, fixed base
c = 4), as the other CPU tests pin them.  Tolerance: exact (points by
their compressed bytes, field elements by their ints)."""

import random

import pytest
import torch

from zukelang_tpu.core import comp as jcomp, qap as jqap
from zukelang_tpu.engine.jax_engine import JaxEngine
from zukelang_tpu.golden.field import Fr as JFr
from zukelang_tpu.rng import Gen as JGen
from zukelang_tpu_torch import params
from zukelang_tpu_torch.core import comp, poly, qap as qap_mod
from zukelang_tpu_torch.engine import get_engine
from zukelang_tpu_torch.engine.base import GoldenEngine
from zukelang_tpu_torch.engine.torch_engine import TorchEngine
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.rng import Gen

from test_torch_core import (both_programs, compile_both, plain,
                             small_windows)  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("small_windows")

GROUPS = {"g1": G1, "g2": G2}


@pytest.fixture(scope="module")
def eng(small_windows):
    return TorchEngine(device="cpu")


def _b(points):
    return [p.to_compressed_bytes() for p in points]


def _points(group, n, rng):
    """n points with infinity at every 7th place."""
    g = GROUPS[group].generator()
    return [GROUPS[group].zero() if i % 7 == 3 else g * rng.randrange(1, 1 << 64)
            for i in range(n)]


def _scalars(n, rng):
    """n scalars with 0 at every 5th place, the rest below r."""
    return [Fr(0 if i % 5 == 2 else rng.randrange(params.R))
            for i in range(n)]


@pytest.mark.parametrize("group,n", [("g1", 0), ("g1", 1), ("g1", 15),
                                     ("g1", 64), ("g1", 100), ("g2", 0),
                                     ("g2", 15), ("g2", 100)])
def test_dot_matches_golden(eng, group, n):
    rng = random.Random(n)
    pts, scs = _points(group, n, rng), _scalars(n, rng)
    if n:
        pts[0] = GROUPS[group].zero()      # infinity with a nonzero scalar
        scs[0] = Fr(12345)
    dot = eng.g1_dot if group == "g1" else eng.g2_dot
    want = GoldenEngine().g1_dot if group == "g1" else GoldenEngine().g2_dot
    assert _b([dot(pts, scs)]) == _b([want(pts, scs)])
    with pytest.raises(ValueError):
        dot(pts + [GROUPS[group].generator()], scs)


def test_apply_powers_takes_the_first_points(eng):
    rng = random.Random(1)
    xis = _points("g1", 9, rng)
    coeffs = _scalars(4, rng)
    assert _b([eng.g1_apply_powers(coeffs, xis)]) == _b(
        [G1.dot(xis[:4], coeffs)])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_powers_match_golden(eng, group):
    s = Fr(0x1234567890ABCDEF)
    got = eng.g1_powers(5, s) if group == "g1" else eng.g2_powers(5, s)
    assert _b(got) == _b(GROUPS[group].powers(5, s))
    assert len(got) == 6


@pytest.mark.parametrize("group,n", [("g1", 0), ("g1", 3), ("g1", 130),
                                     ("g2", 17)])
def test_fixed_base_batch_matches_golden(eng, group, n):
    rng = random.Random(7 + n)
    scs = _scalars(n, rng)
    got = (eng.g1_of_fr_batch if group == "g1" else eng.g2_of_fr_batch)(scs)
    assert _b(got) == _b([GROUPS[group].of_Fr(s) for s in scs])


def _instance(name="cubic", seed=4):
    """One suite program in both packages with its ntt QAPs and witness."""
    jc, tc = compile_both(*both_programs(name))
    q = qap_mod.build(tc.gates, domain="ntt")
    jq = jqap.build(jc.gates, domain="ntt")
    _i, _l, env = comp.gen_inputs(tc.inputs, Gen(seed))
    _i, _l, jenv = jcomp.gen_inputs(jc.inputs, JGen(seed))
    return (q, comp.code_eval_list(env, tc.codes), jq,
            jcomp.code_eval_list(jenv, jc.codes))


@pytest.mark.parametrize("name", ["cubic", "case", "no_one"])
def test_witness_reduction_matches_golden_and_jax(eng, name):
    q, sol, jq, jsol = _instance(name)
    got = eng.qap_witness_reduction(q, sol)
    want = GoldenEngine().qap_witness_reduction(q, sol)
    assert all(poly.equal(a, b) for a, b in zip(got, want))
    jgot = JaxEngine().qap_witness_reduction(jq, jsol)
    assert [plain(poly.normalize(x)) for x in got] == [
        plain(poly.normalize([Fr(v.n) for v in x])) for x in jgot]
    assert poly.equal(eng.qap_eval(q, sol)[1], want[2])


@pytest.mark.parametrize("name", ["cubic", "bool_compound_eq"])
def test_eval_at_matches_golden_and_jax(eng, name):
    q, _sol, jq, _jsol = _instance(name)
    x = Fr(987654321)
    got = eng.qap_eval_at(q, x)
    assert plain(got) == plain(GoldenEngine().qap_eval_at(q, x))
    assert plain(got) == plain(JaxEngine().qap_eval_at(jq, JFr(987654321)))


def test_reference_domain_takes_the_golden_engine(eng):
    _jc, tc = compile_both(*both_programs("cubic"))
    q = qap_mod.build(tc.gates, domain="reference")
    _i, _l, env = comp.gen_inputs(tc.inputs, Gen(4))
    sol = comp.code_eval_list(env, tc.codes)
    gold = GoldenEngine()
    assert plain(eng.qap_witness_reduction(q, sol)) == plain(
        gold.qap_witness_reduction(q, sol))
    assert plain(eng.qap_eval_at(q, Fr(99))) == plain(
        gold.qap_eval_at(q, Fr(99)))


@pytest.mark.parametrize("group,n", [("g1", 1), ("g1", 5), ("g2", 3)])
def test_tree_sum_matches_golden(group, n):
    pts = _points(group, n, random.Random(n))
    pack = C.pack_g1 if group == "g1" else C.pack_g2
    unpack = C.unpack_g1 if group == "g1" else C.unpack_g2
    got = unpack(C.tree_sum(pack(pts, "cpu")))
    want = GROUPS[group].zero()
    for p in pts:
        want = want + p
    assert len(got) == 1 and _b(got) == _b([want])


def test_pack_affine_marks_infinity_with_zeros():
    pts = [G1.generator(), G1.zero()]
    X, Y = C.pack_affine(pts, "g1", "cpu")
    assert not X[:, 1].any() and not Y[:, 1].any()
    assert _b(C.unpack_g1(C.affine_to_jac((X, Y)))) == _b(pts)
    pts2 = [G2.zero(), G2.generator()]
    assert _b(C.unpack_g2(C.affine_to_jac(C.pack_affine(pts2, "g2")))) == _b(
        pts2)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        get_engine("torch")
    assert isinstance(get_engine("torch", device="cpu"), TorchEngine)
    assert isinstance(get_engine(), GoldenEngine)
