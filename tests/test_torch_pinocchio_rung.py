"""The port's Pinocchio keygen and prove (NonZK and ZK) at a tiny instance
of the benchmark rung's shape (`zkbench.protocols.pinocchio`: 12 chain
gates padded with 0 = 0 * 0 gates to a 2^4 domain, zero-valued mid
columns up to 2^4 + 2) against the benchmark's plain reference
(`zkbench/reference/pinocchio.py`, Python integers) on two seeds: every
MSM result and every proof point.  The ZK fold in the host library
(`pinocchio_device.zk_fold`) against the golden fold on random points,
with points at infinity and zero scalars.  The spans of a prove and of a
keygen.

Tolerance: exact (points, names, ids, counts)."""

import json
import os
import random
from types import SimpleNamespace

import pytest
import torch

from zkbench import generator
from zkbench.protocols import pinocchio as bench_pin
from zkbench.protocols.groth16 import Probes, _affine
from zkbench.reference import pinocchio as ref_mod
from zukelang_tpu_torch import params, util
from zukelang_tpu_torch import rng as trng
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.protocols import groth16_device as gd
from zukelang_tpu_torch.protocols import pinocchio_device as pd
from zukelang_tpu_torch.protocols.pinocchio import PROOF_FIELDS, Proof

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (2 ** 31 + 101, 7)
KEYGEN_CHILDREN = {"zk.keygen.lagrange", "zk.keygen.matvec",
                   "zk.keygen.scalar_tables", "zk.keygen.tau_powers",
                   "zk.keygen.fixed_base", "zk.keygen.to_affine",
                   "zk.keygen.host_points"}
PROVE_CHILDREN = {"zk.prove.witness_to_device", "zk.prove.reduction",
                  "zk.prove.msm_launch", "zk.prove.msm_wait",
                  "zk.prove.unpack"}


def _config():
    with open(os.path.join(ROOT, "zkbench/configs/pinocchio-zk-2p14.json")) \
            as f:
        conf = json.load(f)
    conf.update(gates=12, domain_log=4, vars=18)
    return conf


def _run(seed):
    """Keygen, a ZK and a NonZK prove of the padded instance of `seed`
    on the CPU with windows of 4, from an empty ring; the reference."""
    conf = _config()
    inst, coefs = bench_pin.pad(conf, generator.build(conf, {"witnesses": 1},
                                                       seed))
    rows = coefs.reshape(-1, 1).tolist()
    fc = flat.from_arrays(inst.n_vars, inst.logn,
                          *[(g.reshape(-1, 1), rows) for g in inst.gates])
    w = flat.pack_witness_values(inst.witnesses[0])
    d = next(bench_pin.blinding(seed))
    util.reset()
    pkey, _vkey = pd.keygen_device(fc, mids=inst.mids.tolist(),
                                   ios=inst.ios.tolist(),
                                   rng=trng.InjectedRng(list(inst.trapdoor)),
                                   device="cpu")
    proves = {}
    with Probes(False, lambda: None) as probes:
        for zk in (True, False):
            probes.begin(False)
            proof = pd.prove_device(pkey, fc, w, trng.InjectedRng(list(d)),
                                    zk=zk)
            proves[zk] = dict(probes.end(), proof=proof)
    held = inst.n_vars - len(pkey.v_all_tail)
    refs = {zk: ref_mod.for_instance(dict(conf, zk=zk), inst, coefs, held)
            for zk in (True, False)}
    return dict(d=d, proves=proves, refs=refs, spans=util.spans())


@pytest.fixture(scope="module")
def runs():
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        return {seed: _run(seed) for seed in SEEDS}
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved


def _sorted(points):
    return sorted((0,) if p is None else (1, p) for p in points)


@pytest.mark.parametrize("seed", SEEDS)
def test_keygen_and_prove_equal_the_reference(runs, seed):
    run = runs[seed]
    for zk in (True, False):
        got, ref = run["proves"][zk], run["refs"][zk]
        want = ref.msm_points(0)
        assert len(got["g1"]) == (8 if zk else 6) and len(got["g2"]) == 2
        assert _sorted(map(_affine, got["g1"])) == _sorted(want["g1"]), zk
        assert _sorted(map(_affine, got["g2"])) == _sorted(want["g2"]), zk
        proof = tuple(_affine(getattr(got["proof"], k)) for k in PROOF_FIELDS)
        assert proof == ref.proof_points(0, run["d"]), zk


def _rand_g1(rnd):
    return G1.generator() * Fr(rnd.randrange(params.R))


def _rand_g2(rnd):
    return G2.generator() * Fr(rnd.randrange(params.R))


def _golden_fold(pkey, sums, v_all, w_all, tail, dv, dw, dy):
    """The fold as the golden protocol states it (pinocchio.ml:427-514)."""
    if pkey.v_all_tail:
        c = [Fr(x) for x in tail]
        v_all = v_all + G1.dot(pkey.v_all_tail, c)
        w_all = w_all + G1.dot(pkey.w_all_tail, c)
    return Proof(
        vv=sums.vv + pkey.vt * dv, ww=sums.ww + pkey.wt * dw,
        yy=sums.yy + pkey.yt * dy,
        h=(sums.h + v_all * dw + w_all * dv + pkey.t1 * (dv * dw)
           - G1.generator() * dy),
        vavv=sums.vavv + pkey.vavt * dv, waww=sums.waww + pkey.wawt * dw,
        yayy=sums.yayy + pkey.yayt * dy,
        bvwy=sums.bvwy + pkey.vbt * dv + pkey.wbt * dw + pkey.ybt * dy)


@pytest.mark.parametrize("case", ["edges", "random"])
def test_library_fold_equals_golden_fold(case):
    rnd = random.Random(case)
    tails = 3 if case == "random" else 2
    pkey = SimpleNamespace(
        **{k: _rand_g1(rnd) for k in ("vt", "yt", "vavt", "yayt", "vbt",
                                      "wbt", "ybt", "t1")},
        wt=_rand_g2(rnd), wawt=_rand_g2(rnd),
        v_all_tail=[_rand_g1(rnd) for _ in range(tails)],
        w_all_tail=[_rand_g1(rnd) for _ in range(tails)])
    sums = Proof(**{k: (_rand_g2 if k in ("ww", "waww") else _rand_g1)(rnd)
                    for k in PROOF_FIELDS})
    v_all, w_all = _rand_g1(rnd), _rand_g1(rnd)
    tail = [rnd.randrange(params.R) for _ in range(tails)]
    dv, dw, dy = (Fr(rnd.randrange(params.R)) for _ in range(3))
    if case == "edges":
        dy = Fr(0)                       # a zero scalar
        tail[0] = 0                      # a zero tail value
        pkey.ybt = G1.zero()             # a key point at infinity
        pkey.w_all_tail[1] = G1.zero()   # a tail point at infinity
        v_all = G1.zero()                # an MSM sum at infinity
        sums.vv = -(pkey.vt * dv)        # a sum that cancels: vv' = 0
        sums.waww = pkey.wawt * dw       # a sum that doubles
    got = pd.zk_fold(pkey, sums, v_all, w_all, tail, dv, dw, dy)
    want = _golden_fold(pkey, sums, v_all, w_all, tail, dv, dw, dy)
    for k in PROOF_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    if case == "edges":
        assert got.vv.is_zero()


@pytest.mark.parametrize("seed", SEEDS)
def test_prove_spans(runs, seed):
    spans = runs[seed]["spans"]
    proves = [s for s in spans if s.name == "zk.prove"]
    assert len(proves) == 2 and proves[0].request != proves[1].request
    for p, zk in zip(proves, (True, False)):
        kids = [s for s in spans if s.parent == p.id]
        assert {k.name for k in kids} == (
            PROVE_CHILDREN | ({"zk.prove.fold"} if zk else set()))
        mine = [s for s in spans if s.request == p.request]
        assert all(p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
                   for s in mine)
        assert [(k.attrs["group"], k.attrs["msms"]) for k in kids
                if k.name == "zk.prove.msm_launch"] == [
            ("g1", 8 if zk else 6), ("g2", 2)]
        assert [k.attrs["group"] for k in kids
                if k.name == "zk.prove.msm_wait"] == ["g1", "g2"]
        folds = [k for k in kids if k.name == "zk.prove.fold"]
        assert [f.attrs for f in folds] == ([{"tail": 0}] if zk else [])
    assert [s.name for s in spans].count("zk.prove.fold") == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_keygen_spans_share_one_keygen_id(runs, seed):
    spans = runs[seed]["spans"]
    keygens = [s for s in spans if s.name == "zk.keygen"]
    assert len(keygens) == 1
    kg = keygens[0]
    kids = [s for s in spans if s.parent == kg.id]
    assert {k.name for k in kids} == KEYGEN_CHILDREN
    assert sorted((k.attrs["group"], k.attrs["batch"]) for k in kids
                  if k.name == "zk.keygen.fixed_base") == sorted(
        [("g1", b) for b in ("vv", "yy", "vav", "yay", "bvwy", "v_all",
                             "w_all", "si", "vv_io", "yy_io")]
        + [("g2", b) for b in ("ww", "waw", "si2", "ww_io")])
    assert [k.attrs["group"] for k in kids
            if k.name == "zk.keygen.to_affine"] == ["g1", "g2"]
    proves = {s.request for s in spans if s.name == "zk.prove"}
    assert kg.request not in proves
    assert all(s.request == kg.request for s in spans
               if kg.start_ns <= s.start_ns and s.end_ns <= kg.end_ns)
