"""The port's `util.py`: `with_time` and `stage` as the JAX package's
(`tests/test_misc.py`), stage logs on the `zukelang` logger, and
`profile_trace` writing a Chrome trace of a block on the CPU.

Tolerance: exact."""

import json
import logging

import torch

from zukelang_tpu_torch import util


def test_with_time_and_stage(caplog):
    res, dt = util.with_time(lambda x, y=0: x + y, 40, y=2)
    assert res == 42 and dt >= 0
    sink = {}
    with caplog.at_level(logging.INFO, logger="zukelang"):
        with util.stage("x", sink):
            pass
    assert set(sink) == {"x"} and sink["x"] >= 0
    assert [r.getMessage().split(":")[0] for r in caplog.records] == [
        "stage x", "stage x"]


def test_stage_records_on_error():
    sink = {}
    try:
        with util.stage("boom", sink):
            raise KeyError("x")
    except KeyError:
        pass
    assert "boom" in sink


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with util.profile_trace(str(path)):
        torch.arange(8).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
