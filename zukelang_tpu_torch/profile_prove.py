"""Where a prove's time goes on the card: stage times and device time.

    python -m zukelang_tpu_torch.profile_prove --protocol groth16 --log 16
    python -m zukelang_tpu_torch.profile_prove --protocol pinocchio --log 14

Builds the synthetic instance as the benches do (`bench_lib`, padded to
the canonical 2^16 domain), runs keygen and two warm-up proves, then:

  * stage times of `--repeats` proves, host clock, with the card
    synchronised at each stage boundary: the witness reduction, the MSMs
    (from the first MSM launch to the last result read back, both groups)
    and the host rest (proof assembly, the ZK fold), beside the whole
    prove timed without those synchronisations;
  * one prove under `torch.profiler`: the device's busy time (the sum of
    the device time of every kernel, copy and fill, counted on the device
    side only, not again under the host op that launched it), the number
    of kernel launches, and the device time and count of every kernel,
    copy and fill, largest first.

Needs a CUDA device; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import bench_lib
from .engine import torch_engine as te
from .ops import msm as msm_mod
from .protocols import groth16_device as gd
from .protocols import pinocchio_device as pd
from .rng import Gen


def _sync():
    torch.cuda.synchronize()


def _instrument(stages: dict):
    """Wrap the witness reduction and the MSM entry points so that each
    prove records its stage times into `stages` (lists of seconds)."""
    mark = {}
    wr = te.run_witness_reduction

    def run_witness_reduction(*a, **k):
        _sync()
        t0 = time.perf_counter()
        out = wr(*a, **k)
        _sync()
        stages["witness_reduction_s"].append(time.perf_counter() - t0)
        mark["msm_start"] = None
        return out

    def deferred(fn):
        def launch(*a, **k):
            if mark.get("msm_start") is None:
                mark["msm_start"] = time.perf_counter()
            resolve = fn(*a, **k)

            def resolved():
                out = resolve()
                mark["msm_end"] = time.perf_counter()
                return out
            return resolved
        return launch

    te.run_witness_reduction = run_witness_reduction
    msm_mod.msm_many_staged_deferred = deferred(msm_mod.msm_many_staged_deferred)
    msm_mod.msm_staged_deferred = deferred(msm_mod.msm_staged_deferred)
    return mark


def _device_us(e) -> float:
    """Device time of a device-side event (a kernel, copy or fill); 0 for
    a host op, whose device time is that of the kernels it launched,
    which appear as events of their own."""
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(e.self_device_time_total)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocol", choices=("groth16", "pinocchio"),
                    default="groth16")
    ap.add_argument("--log", type=int, default=16,
                    help="log2 of the constraint count")
    ap.add_argument("--nonzk", action="store_true",
                    help="Pinocchio without the ZK randomisation")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_prove: needs a CUDA device")
    dev = torch.device("cuda")

    inst = bench_lib.make_synthetic_r1cs(
        args.log, seed=1, pad_log=bench_lib.canon_pad_log(args.log))
    fc, wm = inst.fc, inst.pack_witness(dev)
    mids, ios = list(inst.mids_cols), list(inst.ios_cols)
    if args.protocol == "groth16":
        key, _ = gd.keygen_device(fc, mids, ios, Gen(b"bench-keygen"), dev)

        def prove(i):
            return gd.prove_device(key, fc, wm, Gen(b"profile-%d" % i))
    else:
        key, _ = pd.keygen_device(fc, mids, ios, Gen(b"bench-pin-keygen"), dev)

        def prove(i):
            return pd.prove_device(key, fc, wm, Gen(b"profile-%d" % i),
                                   zk=not args.nonzk)
    for i in range(2):
        prove(i)
    _sync()

    whole = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        prove(i)
        whole.append(time.perf_counter() - t0)

    stages = {"witness_reduction_s": [], "msm_s": [], "host_s": []}
    mark = _instrument(stages)
    for i in range(args.repeats):
        t0 = time.perf_counter()
        prove(i)
        t1 = time.perf_counter()
        stages["msm_s"].append(mark["msm_end"] - mark["msm_start"])
        stages["host_s"].append(t1 - t0 - stages["witness_reduction_s"][-1]
                                - stages["msm_s"][-1])

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove(0)
        _sync()
        profiled_s = time.perf_counter() - t0
    events = prof.key_averages()
    device = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in events
                     if _device_us(e) > 0), key=lambda r: -r[1])
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    busy_ms = sum(ms for _k, ms, _n in device)
    if busy_ms <= 0:
        raise RuntimeError("profile_prove: the profiler recorded no device "
                           "time")
    prove_s = min(whole)
    res = {
        "protocol": args.protocol + ("" if args.protocol == "groth16" or
                                     not args.nonzk else "_nonzk"),
        "log_constraints": args.log, "domain_log": fc.logn,
        "prove_s": prove_s, "prove_runs_s": whole,
        **{k: min(v) for k, v in stages.items()},
        "profiled_prove_s": profiled_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / prove_s,
        "kernel_launches": launches,
        "device_ms_by_kernel": [[k, round(ms, 4), n] for k, ms, n in device],
        "card": torch.cuda.get_device_name(0),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
