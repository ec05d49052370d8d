"""The readers of the program's spans (`zkbench/program_spans.py` and the
five metrics on it): medians and sums of spans put into the program's
ring, None on an empty ring; a traced CPU run of the 16-gate cell reports
all five.  On the card: the program's spans under `torch.profiler` add
no device-row event, every launch reaches the device as a kernel, and the
proof assembly is a host range."""

import json
import os
import time

import pytest

from conftest import ROOT, tiny_bench

from zkbench import harness, program_spans, trace

SPAN_METRICS = {"witness_copy_ms": "zk.prove.witness_to_device",
                "msm_enqueue_ms": "zk.prove.msm_launch",
                "msm_wait_ms": "zk.prove.msm_wait",
                "assemble_ms": "zk.prove.assemble"}
NEW = sorted(SPAN_METRICS) + ["pack_s"]


@pytest.fixture
def ring():
    from zukelang_tpu_torch import util
    util.reset()
    yield util
    util.reset()


def _read(name):
    return harness._reader(name)({})


def _span(util, name, ms, **attrs):
    """A span of about `ms` milliseconds (its recorded length returned)."""
    with util.stage(name, **attrs) as sp:
        time.sleep(ms / 1e3)
    return sp.end_ns - sp.start_ns


def test_empty_ring_reads_none(ring):
    assert program_spans.ring() == []
    for name in NEW:
        assert _read(name) is None


def test_medians_by_proof_id(ring):
    util = ring
    got = {name: [] for name in SPAN_METRICS.values()}
    for k, ms in enumerate((1, 3, 2)):
        with util.stage("zk.prove", request=util.next_request()):
            for name in SPAN_METRICS.values():
                got[name].append(_span(util, name, ms * (k + 1)))
            # two spans of one name in a prove are summed
            got["zk.prove.msm_launch"][-1] += _span(
                util, "zk.prove.msm_launch", 1)
    _span(util, "zk.prove.assemble", 50)        # outside any prove
    for metric, name in SPAN_METRICS.items():
        want = sorted(got[name])[1] / 1e6
        assert _read(metric) == pytest.approx(want)
    assert program_spans.per_prove_s("zk.prove.unpack") is None


def test_pack_s_sums_set_up_before_the_first_prove(ring):
    util = ring
    a = _span(util, "zk.flat.from_arrays", 2)
    b = _span(util, "zk.flat.pack_witness", 1)
    c = _span(util, "zk.flat.pack_witness", 1)
    _span(util, "zk.ntt.twiddles", 3)
    with util.stage("zk.prove", request=util.next_request()):
        _span(util, "zk.flat.pack_witness", 1)
    _span(util, "zk.flat.pack_witness", 1)
    assert _read("pack_s") == pytest.approx((a + b + c) / 1e9)


def test_a_full_ring_reads_whole_proves_only(monkeypatch, ring, capsys):
    """A ring that has dropped its oldest spans: the medians take only the
    proves whose spans are all kept, and `pack_s`, whose set-up spans
    are gone, reads nothing and says so."""
    import collections
    util = ring
    monkeypatch.setattr(util, "RING_SIZE", 5)
    monkeypatch.setattr(util, "_ring", collections.deque(maxlen=5))
    _span(util, "zk.flat.from_arrays", 1)
    lengths = []
    for ms in (1, 9, 2):
        with util.stage("zk.prove", request=util.next_request()):
            lengths.append(_span(util, "zk.prove.assemble", ms))
            _span(util, "zk.prove.msm_wait", 1)
    # kept: the second prove's wait and parent, the whole third prove;
    # the second prove's assemble span has gone
    assert [s.name for s in util.spans()][:2] == ["zk.prove.msm_wait",
                                                  "zk.prove"]
    assert _read("assemble_ms") == pytest.approx(lengths[2] / 1e6)
    assert len(program_spans.per_prove_s("zk.prove.msm_wait")) == 1
    assert _read("pack_s") is None
    assert "no longer holds set-up" in capsys.readouterr().err


def test_a_program_without_the_ring_reads_none(monkeypatch, ring):
    _span(ring, "zk.flat.from_arrays", 1)
    monkeypatch.delattr(ring, "spans")
    for name in NEW:
        assert _read(name) is None


def test_traced_cpu_run_reports_the_five(tmp_path, monkeypatch, ring,
                                         small_windows):
    """The 16-gate cell traced on the CPU (the profiler left out: its
    CUDA activity is not for a CPU-only torch) reports the five metrics
    and is correct."""
    monkeypatch.setattr(trace, "profile", lambda *a, **k: None)
    bench, _ = tiny_bench(str(tmp_path))
    out = harness.run_cell(bench, "tiny", 2 ** 31 + 91, 0.5, True, "cpu",
                           time.perf_counter(), root=str(tmp_path))
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(got), sorted(got)
    assert all(got[k] > 0 for k in NEW)
    assert got["assemble_ms"] < 1e3 * max(out["record"]["latencies_s"])


@pytest.mark.gpu
def test_spans_under_the_profiler_on_the_card(card, ring):
    """Two 2^16 proves under torch.profiler with CPU and CUDA activity:
    no device-row event named zk.*, the runtime's launch calls equal the
    device's kernels (in one of three tries: the profiler may drop
    records), and `zk.prove.assemble` is a host range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from zkbench.protocols import groth16 as proto
    with open(os.path.join(ROOT, "zkbench/configs/groth16-2p16.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "zkbench/traffic/rand.json")) as f:
        traffic = json.load(f)
    cell = proto.Cell(config, traffic, 2 ** 31 + 17, card)
    for _ in range(2):
        cell.prove()
    cell.sync()
    complete = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                with record_function(trace.PROVE_LABEL):
                    cell.prove()
                    cell.sync()
        events = prof.profiler.kineto_results.events()
        on_device = [e.name() for e in events
                     if trace._is_device(e) and e.name().startswith("zk.")]
        assert on_device == []
        host = [e.name() for e in events if not trace._is_device(e)]
        assert host.count("zk.prove.assemble") == 2
        assert "zk.prove.reduction" not in host   # encloses launches
        summ = trace.summarise(events)
        complete.append(summ["launches"] == summ["device_kernels"])
        if complete[-1]:
            assert "zk.prove.assemble" in dict(summ["idle_gaps"])
            break
    cell.close()
    torch.cuda.synchronize()
    assert complete[-1], complete
