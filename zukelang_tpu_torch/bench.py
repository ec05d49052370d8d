"""The port's bench: SNARK proves on synthetic R1CS, on the card.

Counterpart of the JAX package's root `bench.py`.

    python -m zukelang_tpu_torch.bench

Every line on stdout is one JSON record, flushed at once:

  1. a heartbeat record (`bench_heartbeat`: the plan, the budget and the
     rung timeout) before any device work;
  2. one record per rung, each rung run by `zukelang_tpu_torch.bench_rung`
     in a child process of its own process group under a wall timeout,
     the child's output sent to stderr;
  3. a final headline: the most significant rung that completed, with
     every rung in `detail.rungs`.

Record shape (the JAX package's):

  {"metric": "groth16_prove_2^16", "value": prove_s, "unit": "s",
   "vs_baseline": N, "detail": {..., "backend": "torch-cuda",
   "device": "<card name>, <power limit>"}}

A rung that fails is a record with `value` -1.  The kernels and the host
pairing are built once here, before the rungs, so each child loads the
built libraries.  The port compiles nothing else at run time, so the
default plan runs every rung of the JAX bench: groth16 2^16, pinocchio
2^14 and groth16 2^20.  `vs_baseline` is modeled, not measured
(`bench_rung._ref_cost_s`).

Environment:
  BENCH_LOG_CONSTRAINTS  headline Groth16 rung (default 16)
  BENCH_BUDGET_S         total wall budget in seconds (default 1500)
  BENCH_RUNG_TIMEOUT_S   per-rung wall timeout (default 1440)
  BENCH_SMOKE=1          one in-process Groth16 rung at
                         BENCH_LOG_CONSTRAINTS on the card: windows 4,
                         1 repeat, BENCH_CANON_LOG=0
  BENCH_RUNGS            the plan, e.g. "g16:16,pin:14,g16:20"

Without a CUDA device it exits non-zero at once.  The exit code is 0
when every rung it ran has a time, else 1.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

# the directory that holds the package: the children run from there
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_LOG = 14      # the JAX bench's pinocchio_prove_2^14
BIG_LOG = 20      # the JAX bench's groth16_prove_2^20


def _emit(rec) -> None:
    print(json.dumps(rec), flush=True)


def _log_n() -> int:
    return int(os.environ.get("BENCH_LOG_CONSTRAINTS", "16"))


def _plan():
    """[(proto, log_n)] from BENCH_RUNGS ("g16:"/"groth16:" and "pin:"
    entries), else the headline Groth16 rung, pinocchio 2^14 and groth16
    2^20."""
    env = os.environ.get("BENCH_RUNGS")
    if env:
        out = []
        for tok in env.split(","):
            proto, ln = tok.strip().split(":")
            out.append(("groth16" if proto in ("g16", "groth16")
                        else "pinocchio", int(ln)))
        return out
    plan = [("groth16", _log_n()), ("pinocchio", PIN_LOG),
            ("groth16", BIG_LOG)]
    return list(dict.fromkeys(plan))


def _run_rung_subprocess(proto: str, log_n: int, repeats: int,
                         timeout_s: float, t_start: float) -> dict:
    """One rung in a child process with a hard wall timeout.  On timeout
    the child's process group is killed and the record is an error with
    the last stage progress the child wrote."""
    name = f"{proto}_prove_2^{log_n}"
    fd, out_path = tempfile.mkstemp(prefix="zk_rung_", suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "zukelang_tpu_torch.bench_rung",
           "--proto", proto, "--logn", str(log_n),
           "--repeats", str(repeats), "--out", out_path]
    t0 = time.time()
    try:
        # stdout -> stderr: the child never writes to the JSON stream
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sys.stderr,
                                stderr=sys.stderr, start_new_session=True)
        timed_out = False
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()
            proc.wait()
        wall = time.time() - t0

        payload = None
        try:
            with open(out_path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            pass

        if payload and payload.get("done"):
            rec = payload["record"]
            rec.setdefault("detail", {})["total_wall_s"] = round(
                time.time() - t_start, 1)
            return rec
        progress = (payload or {}).get("progress", {})
        reason = ("timeout" if timed_out
                  else f"child exited rc={proc.returncode}")
        print(f"[bench] {name}: {reason} after {wall:.0f}s, "
              f"progress={progress}", file=sys.stderr, flush=True)
        return {"metric": name, "value": -1, "unit": "s", "vs_baseline": 0,
                "error": f"{reason} after {wall:.0f}s",
                "detail": {"stage_timings": progress,
                           "total_wall_s": round(time.time() - t_start, 1)}}
    finally:
        for path in (out_path, out_path + ".tmp"):
            try:
                os.unlink(path)
            except OSError:
                pass


def _headline(results, log_n: int, total_wall_s: float) -> dict:
    """The most significant completed rung (groth16 at 2^20 or more, then
    the headline size, then any groth16, then the largest), with every
    rung in `detail.rungs`; the last record where none completed."""
    ok = [r for r in results if r["value"] > 0]

    def prio(r):
        g = r["metric"].startswith("groth16")
        ln = int(r["metric"].rsplit("^", 1)[1])
        return (ln >= 20 and g, g and ln == log_n, g, ln)

    if not ok:
        final = dict(results[-1] if results else {
            "metric": f"groth16_prove_2^{log_n}", "value": -1, "unit": "s",
            "vs_baseline": 0, "error": "no rung attempted"})
    else:
        final = dict(max(ok, key=prio))
    final["detail"] = dict(final.get("detail") or {})
    final["detail"]["rungs"] = [
        {"metric": r["metric"], "value": r["value"],
         "vs_baseline": r.get("vs_baseline"),
         "verified": (r.get("detail") or {}).get("verified"),
         "keygen_s": (r.get("detail") or {}).get("keygen_s"),
         "error": r.get("error")}
        for r in results]
    final["detail"]["total_wall_s"] = round(total_wall_s, 1)
    return final


def _smoke() -> int:
    """One Groth16 rung in this process, on the card, at windows 4."""
    os.environ.setdefault("BENCH_CANON_LOG", "0")
    from .bench_rung import run_rung
    from .protocols import groth16_device as gd
    gd.DEFAULT_MSM_WINDOW = 4
    gd.DEFAULT_FB_WINDOW = 4
    rec = run_rung("groth16", _log_n(), 1, {})
    _emit(rec)
    return 0 if rec["value"] > 0 else 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    if os.environ.get("BENCH_SMOKE", "") == "1":
        return _smoke()
    t_start = time.time()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1500"))
    rung_timeout_s = float(os.environ.get("BENCH_RUNG_TIMEOUT_S", "1440"))
    rungs = _plan()
    _emit({"metric": "bench_heartbeat", "value": 0, "unit": "s",
           "vs_baseline": 0,
           "detail": {"plan": [f"{p}:{ln}" for p, ln in rungs],
                      "budget_s": budget_s,
                      "rung_timeout_s": rung_timeout_s}})

    from concurrent.futures import ThreadPoolExecutor
    from . import build, native
    with ThreadPoolExecutor(2) as pool:
        for b in [pool.submit(build.library), pool.submit(native.library)]:
            b.result()
    print(f"[bench] kernels and host pairing built in "
          f"{time.time() - t_start:.1f}s", file=sys.stderr, flush=True)

    results = []
    for i, (proto, log_n) in enumerate(rungs):
        remaining = budget_s - (time.time() - t_start)
        if i > 0 and remaining < 120:
            print(f"[bench] skipping {proto} 2^{log_n}: only "
                  f"{remaining:.0f}s of budget left", file=sys.stderr,
                  flush=True)
            continue
        timeout_s = min(rung_timeout_s, max(60.0, remaining - 30.0))
        rec = _run_rung_subprocess(proto, log_n, 3, timeout_s, t_start)
        _emit(rec)
        results.append(rec)

    _emit(_headline(results, _log_n(), time.time() - t_start))
    return 0 if results and all(r["value"] > 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
