"""The metric arithmetic: the rate over the whole window, the p90 over
every proof, idle as a union of intervals; a stall inside the window
moves each of them."""

import pytest

from zkbench import harness, trace


def _read(name, rec):
    return harness._reader(name)(rec)


def _rec(lat, window_s=None):
    return {"latencies_s": lat,
            "window_s": sum(lat) if window_s is None else window_s}


def test_rate_over_the_whole_window():
    lat = [0.3] * 100
    assert _read("proofs_per_s", _rec(lat)) == pytest.approx(100 / 30)
    stalled = lat[:50] + [2.3] + lat[51:]
    assert _read("proofs_per_s", _rec(stalled)) == pytest.approx(100 / 32)


def test_p90_over_every_proof():
    lat = [0.1 * (i + 1) for i in range(10)]            # 0.1 .. 1.0
    assert _read("prove_p90_s", _rec(lat)) == pytest.approx(0.91)
    base = [0.3] * 100
    assert _read("prove_p90_s", _rec(base)) == pytest.approx(0.3)
    stalls = [0.3] * 85 + [1.0] * 15          # 15 % of proves stall
    assert _read("prove_p90_s", _rec(stalls)) == pytest.approx(1.0)


def test_union_not_sum():
    busy, gaps = trace.union_seconds([(0, 4), (2, 6), (8, 9)], 0, 10)
    assert busy == 7 and gaps == [(6, 8), (9, 10)]
    busy, gaps = trace.union_seconds([(-5, 1), (9, 15)], 0, 10)
    assert busy == 2 and gaps == [(1, 9)]
    assert trace.union_seconds([], 0, 10) == (0, [(0, 10)])


class _Ev:
    def __init__(self, name, s, e, device=False, corr=0):
        self._n, self._s, self._e, self._d = name, s, e, device
        self._c = corr

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def _events(stall_ns=0):
    """One prove of 1 s: two launches, two overlapping kernels, a copy;
    the second launch and the copy inside the MSM range."""
    end = 1_000_000_000 + stall_ns
    return [_Ev(trace.PROVE_LABEL, 0, end),
            _Ev(trace.PROVE_LABEL, 100, end, True),    # the label's row
            _Ev(trace.MSM_LABEL, 25, end - 10),
            _Ev("cudaLaunchKernel", 10, 20, corr=1),
            _Ev("cudaLaunchKernel", 30, 40, corr=2),
            _Ev("cudaMemcpyAsync", 50, 60, corr=3),
            _Ev("aten::copy_", 500_000_000, 500_000_000 + stall_ns + 1),
            _Ev("k_a", 100, 400_000_000, True, corr=1),
            _Ev("k_b", 300_000_000, 500_000_000, True, corr=2),
            _Ev("Memcpy HtoD", end - 100_000_000, end, True, corr=3)]


def test_trace_summary_and_a_stall():
    s = trace.summarise(_events())
    assert s["launches"] == 2 and s["device_kernels"] == 2
    assert s["busy_s"] == pytest.approx(0.6 - 1e-7)
    idle = _read("idle_share", {"trace": s})
    assert idle == pytest.approx(40.0, abs=1e-4)
    assert _read("launches_per_proof", {"trace": s}) == 2
    assert s["device_ops"][0][0] == "k_a"
    stalled = trace.summarise(_events(stall_ns=1_000_000_000))
    assert stalled["busy_s"] == pytest.approx(s["busy_s"])
    assert _read("idle_share", {"trace": stalled}) > idle + 25
    assert stalled["idle_gaps"][0][0] == "aten::copy_"


def test_msm_device_time_by_correlation():
    s = trace.summarise(_events())
    # k_b (0.3-0.5 s) and the copy (0.9-1.0 s): k_a was launched before
    assert s["msm_launches"] == 1 and s["msm_kernels"] == 1
    assert s["msm_device_s"] == pytest.approx(0.3)
    stalled = trace.summarise(_events(stall_ns=1_000_000_000))
    assert stalled["msm_device_s"] == pytest.approx(0.3)
    # a launch in the range without its device record: no time at all
    dropped = [e for e in _events() if e.name() != "k_b"]
    assert trace.summarise(dropped)["msm_device_s"] is None
    # no range labelled: no time
    unlabelled = [e for e in _events() if e.name() != trace.MSM_LABEL]
    assert trace.summarise(unlabelled)["msm_device_s"] is None


def test_spans_and_roofline():
    rec = {"spans": {"prove_s": [0.3, 0.3], "reduction_s": [0.01, 0.01],
                     "msm_s": [0.2, 0.24]},
           "msm_terms": {"g1": [4], "g2": [4]},
           "trace": {"proves": 2, "msm_device_s": 0.4},
           "peak_limb_products_per_s": 1e9}
    assert _read("reduction_ms", rec) == pytest.approx(10)
    assert _read("msm_ms", rec) == pytest.approx(220)
    assert _read("host_ms", rec) == pytest.approx(70)
    from zkbench import costs
    least = costs.msm_limb_products(rec["msm_terms"]) / 1e9
    assert _read("msm_roofline", rec) == pytest.approx(100 * least / 0.2)
    # device time, not the host span: a slower host leaves it alone
    slow = dict(rec, spans={"prove_s": [0.5, 0.5], "reduction_s": [0.01] * 2,
                            "msm_s": [0.4, 0.44]})
    assert _read("msm_roofline", slow) == _read("msm_roofline", rec)
    for part in ("trace", "peak_limb_products_per_s"):
        assert _read("msm_roofline", dict(rec, **{part: None})) is None
    for name in ("reduction_ms", "msm_ms", "host_ms", "msm_roofline",
                 "idle_share", "launches_per_proof"):
        assert _read(name, {}) is None        # nothing to read: no number


def test_every_metric_has_a_reader():
    bench = harness.load_benchmark(harness.HERE + "/..")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness._reader(m["name"]))
