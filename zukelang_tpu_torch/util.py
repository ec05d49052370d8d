"""Timing and stage logging — `with_time` and the stage traces of the
reference harness (misc.ml:3-7; Format.ef logging in test/test.ml:28-97).

The port's own copy of `zukelang_tpu/util.py`.  Structured per-stage
timers; enable verbose stage logs with ZUKELANG_LOG=1 or
logging.getLogger("zukelang").setLevel(INFO).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger("zukelang")
if os.environ.get("ZUKELANG_LOG"):
    logging.basicConfig(level=logging.INFO)
    log.setLevel(logging.INFO)


def with_time(fn, *args, **kwargs):
    """Returns (result, elapsed_seconds) — misc.ml:3-7."""
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    return res, time.perf_counter() - t0


@contextlib.contextmanager
def stage(name: str, sink: dict = None):
    """Stage timer: `with stage("keygen", timings): ...`."""
    t0 = time.perf_counter()
    log.info("stage %s: start", name)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        log.info("stage %s: %.3fs", name, dt)
        if sink is not None:
            sink[name] = dt


@contextlib.contextmanager
def profile_trace(path: str):
    """`torch.profiler` trace of the block, written to `path` as a Chrome
    trace when the block ends: CPU and CUDA activity, CPU alone where
    CUDA is absent."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
