"""One timing helper for the port's scripts (`chip_smoke.py`,
`profile_msm`, `probe_looped`, `profile_kernels`, `profile_prove`), and
the card line every measurement is reported beside.

`time_ms(fn, dev, reps, stat)` calls `fn` once to warm up, then `reps`
times, each call between its own pair of CUDA events on the card (the
host clock on the CPU), and returns (statistic of the per-call
milliseconds, the last call's output).  `stat` is "min" or "mean".  A
call that reads the card from the host (a `bool(tensor)`) is timed from
its first launch to its last, its host waits included.
"""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, reps: int = 5, stat: str = "min"):
    """-> (min or mean milliseconds of `reps` calls after a warm-up,
    output of the last call)."""
    if stat not in ("min", "mean"):
        raise ValueError(f"time_ms: stat must be 'min' or 'mean', not {stat!r}")
    out = fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) for s, e in events]
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return (min(times) if stat == "min" else sum(times) / len(times)), out
