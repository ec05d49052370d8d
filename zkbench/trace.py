"""Whole proves under `torch.profiler`: the device's busy time as a union
of intervals, the launches, and the breakdown of a traced window.

Completeness: every kernel launch the host makes (the CUDA runtime's
launch calls, `LAUNCH_CALLS`) must appear as a kernel on the device.
Where the profiler dropped device records the counts differ, and the
caller profiles fewer proves at a time.

The MSMs' device time: the host ranges labelled MSM_LABEL (from a
prove's first MSM launch to its last result read back) select the
runtime calls made inside them; their device operations, matched by
correlation id, give the union of device intervals.  Where a launch in a
range has no device record the time is not reported.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
PROVE_LABEL = "zkbench.prove"
MSM_LABEL = "zkbench.msm"
TOP = 10


def union_seconds(intervals: List[Tuple[float, float]], lo: float,
                  hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of intervals clipped to [lo, hi], and the
    gaps between them inside [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def summarise(events) -> Optional[dict]:
    """Kineto events of one profiled stretch -> its window (from the first
    prove's start to the last one's end), busy seconds, launches, device
    kernels, and the breakdown; None where no prove was labelled."""
    proves = [(e.start_ns(), e.end_ns()) for e in events
              if not _is_device(e) and e.name() == PROVE_LABEL]
    if not proves:
        return None
    lo, hi = min(p[0] for p in proves), max(p[1] for p in proves)
    msm = [(e.start_ns(), e.end_ns()) for e in events
           if not _is_device(e) and e.name() == MSM_LABEL]
    dev, host = [], []
    launches = kernels = msm_launches = 0
    msm_calls = set()
    by_corr: Dict[int, Tuple[int, int, str]] = {}
    by_op: Dict[str, float] = defaultdict(float)
    api: Dict[str, int] = defaultdict(int)
    for e in events:
        name = e.name()
        s, t = e.start_ns(), e.end_ns()
        if _is_device(e):
            if t <= lo or s >= hi or name in (PROVE_LABEL, MSM_LABEL):
                continue        # the labels' own spans on the device row
            dev.append((s, t))
            by_op[name] += (t - s) / 1e9
            kernels += _is_kernel(name)
            by_corr[e.correlation_id()] = (s, t, name)
        else:
            if name.startswith("cu") and lo <= s <= hi:
                api[name] += 1
                if any(a <= s <= b for a, b in msm):
                    msm_calls.add(e.correlation_id())
                    msm_launches += name in LAUNCH_CALLS
            if name in LAUNCH_CALLS and lo <= s <= hi:
                launches += 1
            if name not in (PROVE_LABEL, MSM_LABEL):
                host.append((s, t, name))
    busy_ns, gaps = union_seconds(dev, lo, hi)
    msm_ops = [by_corr[c] for c in msm_calls if c in by_corr]
    msm_kernels = sum(_is_kernel(name) for _s, _t, name in msm_ops)
    msm_ns = (union_seconds([(s, t) for s, t, _n in msm_ops], lo, hi)[0]
              if msm and msm_kernels == msm_launches else 0)
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy_ns / 1e9,
            "proves": len(proves), "launches": launches,
            "device_kernels": kernels, "api_calls": dict(api),
            "msm_ranges": len(msm), "msm_launches": msm_launches,
            "msm_kernels": msm_kernels,
            "msm_device_s": msm_ns / 1e9 if msm_ns else None,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _gap_owners(gaps, host)}


def _gap_owners(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing: the innermost host event
    that spans the middle of each gap ("python" where none does)."""
    if not gaps:
        return []
    starts = np.array([h[0] for h in host] or [0], dtype=np.int64)
    ends = np.array([h[1] for h in host] or [0], dtype=np.int64)
    names = [h[2] for h in host] or ["python"]
    spans = ends - starts
    owner: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (names[inside[np.argmin(spans[inside])]] if len(inside)
                else "python")
        owner[name] += (e - s) / 1e9
    return sorted(owner.items(), key=lambda kv: -kv[1])[:TOP]


def profile(prove: Callable[[], None], count: int, sync) -> Optional[dict]:
    """`count` proves under torch.profiler, each labelled; -> `summarise`
    of their events, with `complete` set where every launch reached the
    device."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            with record_function(PROVE_LABEL):
                prove()
                sync()
    out = summarise(prof.profiler.kineto_results.events())
    if out is not None:
        out["complete"] = (out["launches"] == out["device_kernels"]
                           and out["busy_s"] > 0)
    return out


def profile_complete(prove, counts=(3, 2, 1), sync=lambda: None,
                     attempts: int = 2) -> Optional[dict]:
    """The first complete profile, trying each count of proves in turn
    (`attempts` times each); None where none was complete."""
    for count in counts:
        for _ in range(attempts):
            t0 = time.perf_counter()
            out = profile(prove, count, sync)
            if out is not None:
                print("zkbench.trace:", {k: out[k] for k in (
                    "proves", "launches", "device_kernels", "busy_s",
                    "window_s", "msm_ranges", "msm_launches", "msm_kernels",
                    "msm_device_s", "api_calls")}, file=sys.stderr)
            if out is not None and out["complete"]:
                out["profile_s"] = time.perf_counter() - t0
                return out
    return None
