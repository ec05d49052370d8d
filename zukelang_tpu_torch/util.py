"""Timing, stage logging, and the port's spans.

`with_time` and `stage` are the stage traces of the reference harness
(misc.ml:3-7; Format.ef logging in test/test.ml:28-97); the port's own
copy of `zukelang_tpu/util.py`.  Enable verbose stage logs with
ZUKELANG_LOG=1 or logging.getLogger("zukelang").setLevel(INFO).

Every `stage` is also a span: when it ends, a `Span` goes into one
bounded in-memory ring (`RING_SIZE` spans, the oldest dropped first),
read with `spans()`.  A span knows its parent (the innermost open span
of its thread) and its request: a proof id for a prove, a keygen id for
a keygen (`next_request()`), taken over by every span inside.  A span
takes attributes while it is open (`annotate`); `reset()` clears the
ring.  Recording is always on: two `perf_counter_ns` calls and one
append a span, no synchronise.

A span declared `host=True` is host-only work that launches nothing on
the card.  While `torch.profiler` is recording, such a span also
opens a `record_function` range of its name, so that the device trace
names the card's idle time after it.  Spans that enclose launches or
copies never open one: Kineto would put their ranges on the device's
rows.  Span names start with `zk.`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import sys
import threading
import time
from typing import List, NamedTuple, Optional

log = logging.getLogger("zukelang")
if os.environ.get("ZUKELANG_LOG"):
    logging.basicConfig(level=logging.INFO)
    log.setLevel(logging.INFO)

RING_SIZE = 65536


class Span(NamedTuple):
    """One finished span, on the host's `time.perf_counter_ns` clock.
    `parent` and `request` are 0 where there is none."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    attrs: dict


_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


def _open_spans() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def with_time(fn, *args, **kwargs):
    """Returns (result, elapsed_seconds) — misc.ml:3-7."""
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    return res, time.perf_counter() - t0


class Stage:
    """An open span (see `stage`); after the block, `seconds` is its
    length and `attrs` may still be added to before it ends."""

    __slots__ = ("name", "sink", "host", "attrs", "id", "parent", "request",
                 "start_ns", "end_ns", "_range", "_log", "_stack")

    def __init__(self, name: str, sink: Optional[dict], host: bool,
                 request: Optional[int], attrs: dict):
        self.name, self.sink, self.host = name, sink, host
        self.request, self.attrs = request, attrs

    def __enter__(self) -> "Stage":
        self._stack = stack = _open_spans()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else 0
        if self.request is None:
            self.request = top.request if top is not None else 0
        self.id = next(_span_ids)
        self._range = None
        if self.host and _profiling():
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self._log = log.isEnabledFor(logging.INFO)
        if self._log:
            log.info("stage %s: start", self.name)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        # a plain tuple: `spans()` makes the Span records when read
        _ring.append((self.name, self.start_ns, self.end_ns, self.id,
                      self.parent, self.request, self.attrs))
        dt = self.seconds
        if self._log:
            log.info("stage %s: %.3fs", self.name, dt)
        if self.sink is not None:
            self.sink[self.name] = dt
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def stage(name: str, sink: dict = None, *, host: bool = False,
          request: int = None, **attrs) -> Stage:
    """Stage timer and span: `with stage("keygen", timings): ...` logs
    the stage, sets `timings["keygen"]` to its seconds and records a
    span with `attrs`.  `request` starts a request's spans (a proof or
    keygen id); without it the span belongs to its parent's request.
    `host=True`: see the module's docstring."""
    return Stage(name, sink, host, request, attrs)


def next_request() -> int:
    """A new request id (for a prove or a keygen), unique in the process."""
    return next(_request_ids)


def spans() -> List[Span]:
    """The ring's spans, oldest first (in the order they ended)."""
    return [Span._make(t) for t in _ring]


def annotate(**attrs) -> None:
    """Adds `attrs` to the innermost open span of this thread, if any: a
    callee records what it chose on its caller's span."""
    stack = _open_spans()
    if stack:
        stack[-1].attrs.update(attrs)


def reset() -> None:
    """Clears the ring."""
    _ring.clear()


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
