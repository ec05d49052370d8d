"""The port's spans (`util.stage`): a prove's and a keygen's spans on the
CPU plain versions, each under one request id and its parent; the
collision-safe re-run's span; the ring's bound; `annotate`; `host=True`
ranges under `torch.profiler`.

Tolerance: exact (names, ids, counts); durations only ordered."""

import pytest
import torch

from zukelang_tpu_torch import bench_lib, util
from zukelang_tpu_torch import rng as trng
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.golden.curve import G1
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FR
from zukelang_tpu_torch.protocols import groth16_device as gd

torch.set_num_threads(1)

PROVE_CHILDREN = {"zk.prove.witness_to_device", "zk.prove.reduction",
                  "zk.prove.msm_launch", "zk.prove.msm_wait",
                  "zk.prove.unpack", "zk.prove.assemble"}
KEYGEN_CHILDREN = {"zk.keygen.lagrange", "zk.keygen.matvec",
                   "zk.keygen.tau_powers", "zk.keygen.fixed_base",
                   "zk.keygen.to_affine", "zk.keygen.host_points"}


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


@pytest.fixture(scope="module")
def run():
    """The 16-gate synthetic circuit: flattened, keyed and proved twice
    on the CPU with windows of 4, from an empty ring."""
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    util.reset()
    try:
        inst = bench_lib.make_synthetic_r1cs(4)
        crs, vkey = gd.keygen_device(
            inst.fc, mids=list(inst.mids_cols), ios=list(inst.ios_cols),
            rng=trng.InjectedRng([11, 12, 13, 14, 15]), device="cpu")
        w = flat.pack_witness_values(inst.witness)
        proofs = [gd.prove_device(crs, inst.fc, w, trng.InjectedRng([r, s]))
                  for r, s in ((21, 22), (31, 32))]
        spans = util.spans()
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved
    public = {int(c): Fr(inst.witness[c]) for c in inst.ios_cols}
    return dict(spans=spans, proofs=proofs, vkey=vkey, public=public)


def test_proofs_verify(run):
    for proof in run["proofs"]:
        assert gd.verify(run["public"], run["vkey"], proof)


def test_prove_spans_share_one_proof_id(run):
    proves = [s for s in run["spans"] if s.name == "zk.prove"]
    assert len(proves) == 2
    assert proves[0].request != proves[1].request
    assert all(p.parent == 0 for p in proves)
    for p in proves:
        kids = _children(run["spans"], p)
        assert {k.name for k in kids} == PROVE_CHILDREN
        assert all(k.request == p.request for k in kids)
        assert [k.attrs["group"] for k in kids
                if k.name == "zk.prove.msm_launch"] == ["g1", "g2"]
        assert [k.attrs["group"] for k in kids
                if k.name == "zk.prove.msm_wait"] == ["g1", "g2"]
        launch = next(k for k in kids if k.name == "zk.prove.msm_launch")
        assert launch.attrs == {"group": "g1", "msms": 4, "n": 64, "c": 4,
                                "windows": 64}
        assert sum(k.end_ns - k.start_ns for k in kids) <= \
            p.end_ns - p.start_ns
        assert all(p.start_ns <= k.start_ns <= k.end_ns <= p.end_ns
                   for k in kids)
        mine = [s for s in run["spans"] if s.request == p.request]
        assert all(s.name.startswith("zk.") for s in mine)


def test_prove_counts_from_spans(run):
    names = [s.name for s in run["spans"]]
    assert names.count("zk.prove") == 2
    assert names.count("zk.prove.msm_wait") == 4     # two resolves a prove
    assert "zk.msm.safe_rerun" not in names
    # the witness was on the device: nothing copied
    assert [s.attrs["bytes"] for s in run["spans"]
            if s.name == "zk.prove.witness_to_device"] == [0, 0]


def test_one_assemble_span_a_prove(run):
    """The host library's assembly runs once a prove, inside it: the
    count of `zk.prove.assemble` spans is the count of proves."""
    proves = [s for s in run["spans"] if s.name == "zk.prove"]
    assembles = [s for s in run["spans"] if s.name == "zk.prove.assemble"]
    assert len(assembles) == len(proves) == 2
    assert sorted(s.parent for s in assembles) == sorted(p.id for p in proves)


def test_keygen_spans_share_one_keygen_id(run):
    keygens = [s for s in run["spans"] if s.name == "zk.keygen"]
    assert len(keygens) == 1
    kg = keygens[0]
    kids = _children(run["spans"], kg)
    assert {k.name for k in kids} == KEYGEN_CHILDREN
    assert sorted((k.attrs["group"], k.attrs["batch"]) for k in kids
                  if k.name == "zk.keygen.fixed_base") == [
        ("g1", "crs"), ("g1", "vkey"), ("g2", "crs")]
    proves = {s.request for s in run["spans"] if s.name == "zk.prove"}
    assert kg.request not in proves
    assert all(s.request == kg.request for s in run["spans"]
               if kg.start_ns <= s.start_ns and s.end_ns <= kg.end_ns)


def test_set_up_spans():
    util.reset()
    inst = bench_lib.make_synthetic_r1cs(3)
    w = flat.pack_witness_values(inst.witness)
    assert [s.name for s in util.spans()] == ["zk.flat.from_arrays",
                                              "zk.flat.pack_witness"]
    assert inst.fc.n_gates == 8 and w.shape == (FR.nl, len(inst.witness) + 1)


def test_collision_records_a_safe_rerun(monkeypatch):
    """Equal points in one bucket make K5's mixed add hit the doubling
    case: the resolve re-runs the safe path under its own span."""
    n = 64
    g = G1.generator()
    calls = []
    real_safe = msm._msm_safe_impl

    def spy(*a, **kw):
        calls.append([s.name for s in util._open_spans()])
        return real_safe(*a, **kw)

    monkeypatch.setattr(msm, "_msm_safe_impl", spy)
    util.reset()
    with util.stage("zk.test.wait", request=util.next_request()) as wait:
        res = msm.msm_staged_deferred(C.to_affine(C.pack_g1([g * 5] * n)),
                                      F.pack([7] * n, FR), group="g1",
                                      c=6)()
    assert C.unpack_g1(res)[0] == g * (5 * 7 * n)
    assert calls == [["zk.test.wait", "zk.msm.safe_rerun"]]
    rerun = [s for s in util.spans() if s.name == "zk.msm.safe_rerun"]
    assert len(rerun) == 1
    assert rerun[0].parent == wait.id and rerun[0].request == wait.request
    assert rerun[0].attrs == {"group": "g1", "msms": 1}


def test_ring_stays_bounded():
    util.reset()
    total = util.RING_SIZE + 100
    for i in range(total):
        with util.stage("zk.test.tick", i=i):
            pass
    got = util.spans()
    assert len(got) == util.RING_SIZE
    assert [s.attrs["i"] for s in got[:2]] == [100, 101]
    assert got[-1].attrs["i"] == total - 1
    util.reset()
    assert util.spans() == []


def test_annotate_and_reset():
    """`annotate` adds to the innermost open span only, and is a no-op
    outside any span; `reset` empties the ring."""
    util.reset()
    util.annotate(lost=1)
    with util.stage("zk.outer", a=1):
        with util.stage("zk.inner"):
            util.annotate(c=4)
        util.annotate(b=2)
    assert [(s.name, s.attrs) for s in util.spans()] == [
        ("zk.inner", {"c": 4}), ("zk.outer", {"a": 1, "b": 2})]
    util.reset()
    assert util.spans() == []


def test_nesting_parents_and_requests():
    util.reset()
    rid = util.next_request()
    with util.stage("zk.outer", request=rid) as outer:
        with util.stage("zk.inner", k=1) as inner:
            pass
    with util.stage("zk.alone") as alone:
        pass
    assert inner.parent == outer.id and inner.request == rid
    assert outer.parent == 0 and alone.request == 0 and alone.parent == 0
    assert [s.name for s in util.spans()] == ["zk.inner", "zk.outer",
                                              "zk.alone"]
    assert util.spans()[0].attrs == {"k": 1}
    assert util.next_request() > rid


def test_stage_formats_nothing_when_logging_is_off(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("formatted a log line")
    monkeypatch.setattr(util.log, "info", boom)
    monkeypatch.setattr(util.log, "isEnabledFor", lambda level: False)
    sink = {}
    with util.stage("zk.quiet", sink):
        pass
    assert sink["zk.quiet"] >= 0


def test_host_spans_open_profiler_ranges_only_when_profiling():
    """`host=True` spans appear as ranges in a CPU profile; other spans
    do not; outside a profile no range is opened."""
    from torch.profiler import ProfilerActivity, profile
    with util.stage("zk.test.unprofiled", host=True) as sp:
        pass
    assert sp._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with util.stage("zk.test.host", host=True):
            torch.zeros(4).sum()
        with util.stage("zk.test.device"):
            torch.zeros(4).sum()
    names = {e.name for e in prof.events()}
    assert "zk.test.host" in names
    assert "zk.test.device" not in names
