"""MSM / NTT scaling efficiency across world sizes.

Counterpart of `zukelang_tpu/parallel/scaling.py`.  Each world size D is a
new world of D ranks (`launch.spawn`): NCCL ranks on the card, one a
card, or gloo ranks on the CPU.  Efficiency is eff(D) = t(1) / (D t(D)),
with t the slowest rank's host time around a call that ends synchronised.
On the CPU the ranks share one host's cores, so the numbers there show
the code path's structure and the collectives' overhead, not a card's.

    python -m zukelang_tpu_torch.parallel.scaling --logn 12 --window 8 \
        --ntt-logn 16 [--max-windows W] [--device cpu] [--ranks N] \
        [--out PATH]

The default world sizes are 1, 2, 4, ... up to the cards the host has, or
up to --ranks with --device cpu.  Without CUDA it refuses to run unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from .. import params
from ..golden.curve import G1
from ..ops import curve as C
from ..ops import field as F
from ..params import FR
from . import launch, sharded


def default_counts(device=None, ranks: int = 1) -> list:
    """1, 2, 4, ... up to the host's cards (NCCL) or `ranks` (CPU)."""
    top = (ranks if torch.device(device or "cuda").type == "cpu"
           else torch.cuda.device_count())
    return [d for d in (1, 2, 4, 8, 16, 32) if d <= top]


def _msm_inputs(logn: int, device):
    """64 distinct base points tiled to 2^logn, scalars from seed 1 (the
    JAX harness's inputs)."""
    random.seed(1)
    n = 1 << logn
    base = [G1.generator() * (i + 1) for i in range(64)]
    P = tuple(x.repeat(1, n // 64) for x in C.pack_g1(base, device))
    S = F.pack([random.randrange(params.R) for _ in range(n)], FR, device)
    return P, S


def msm_rank(mesh, logn: int, c: int, max_windows) -> dict:
    """Rank target: one warm-up and one timed `sharded_msm_g1`."""
    P, S = _msm_inputs(logn, mesh.device)
    sharded.sharded_msm_g1(mesh, P, S, c=c, max_windows=max_windows)
    mesh.sync()
    t0 = time.perf_counter()
    sharded.sharded_msm_g1(mesh, P, S, c=c, max_windows=max_windows)
    return {"time_s": np.array(time.perf_counter() - t0)}


def _ntt_split(logn: int):
    log2 = logn // 2
    return logn - log2, log2


def ntt_rank(mesh, logn: int, repeats: int, phases: bool) -> dict:
    """Rank target: the best of `repeats` warm `sharded_ntt` calls (seed
    2's vector), and with `phases` the phase breakdown."""
    random.seed(2)
    log1, log2 = _ntt_split(logn)
    x = F.pack_mont([random.randrange(params.R) for _ in range(1 << logn)],
                    FR, mesh.device).reshape(FR.nl, 1 << log1, 1 << log2)
    sharded.sharded_ntt(mesh, x, log1, log2)
    best = None
    for _ in range(repeats):
        mesh.sync()
        t0 = time.perf_counter()
        sharded.sharded_ntt(mesh, x, log1, log2)
        mesh.sync()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    out = {"time_s": np.array(best)}
    if phases:
        pt = sharded.sharded_ntt_phase_times(mesh, x, log1, log2,
                                             repeats=repeats)
        out.update({f"phase.{k}": np.array(v) for k, v in pt.items()})
    return out


def _slowest(ranks: list, key: str) -> float:
    return max(float(r[key]) for r in ranks)


def measure_msm_scaling(logn: int, device_counts=None, c: int = 8,
                        max_windows: int = None, device=None) -> dict:
    """{D: {time_s, mterms_per_s, efficiency}} of the term-sharded G1 MSM
    at 2^logn terms."""
    counts = device_counts or default_counts(device)
    n = 1 << logn
    results, t1 = {}, None
    for d in counts:
        dt = _slowest(launch.spawn("zukelang_tpu_torch.parallel.scaling."
                                   "msm_rank", d, device, logn, c,
                                   max_windows), "time_s")
        t1 = dt if t1 is None else t1
        results[d] = {"time_s": dt, "mterms_per_s": n / dt / 1e6,
                      "efficiency": t1 / (d * dt)}
    return results


def measure_ntt_scaling(logn: int, device_counts=None, repeats: int = 3,
                        device=None) -> dict:
    """{D: {time_s, melems_per_s, efficiency}} of the four-step NTT at
    2^logn (strong scaling); the largest world also has
    `phase_breakdown`."""
    counts = device_counts or default_counts(device)
    log1, log2 = _ntt_split(logn)
    counts = [d for d in counts if not (1 << log2) % d and not (1 << log1) % d]
    n = 1 << logn
    results, t1 = {}, None
    for d in counts:
        ranks = launch.spawn("zukelang_tpu_torch.parallel.scaling.ntt_rank",
                             d, device, logn, repeats, d == counts[-1])
        dt = _slowest(ranks, "time_s")
        t1 = dt if t1 is None else t1
        results[d] = {"time_s": dt, "melems_per_s": n / dt / 1e6,
                      "efficiency": t1 / (d * dt)}
        if d == counts[-1]:
            results[d]["phase_breakdown"] = {
                k: _slowest(ranks, "phase." + k) for k in (
                    "col_ntt_s", "twiddle_s", "all_to_all_s", "row_ntt_s",
                    "total_s")}
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logn", type=int, default=12)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--ntt-logn", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the CPU (default: the card)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="the largest world on the CPU")
    ap.add_argument("--out", type=str, default=None,
                    help="write the JSON document to this path")
    args = ap.parse_args(argv)
    cpu = torch.device(args.device or "cuda").type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("scaling: needs a CUDA device (pass --device cpu "
                         "for gloo on the CPU)")
    counts = default_counts(args.device, args.ranks)
    res = {
        "note": (f"backend={launch._backend(args.device)}, world sizes "
                 f"{counts}" + (": gloo ranks share one host's cores, so "
                                "efficiency shows code-path structure and "
                                "collective overhead" if cpu else
                                f", card {torch.cuda.get_device_name(0)}")),
        "devices": args.ranks if cpu else torch.cuda.device_count(),
        "msm": {"logn": args.logn, "window": args.window,
                "scaling": measure_msm_scaling(
                    args.logn, counts, c=args.window,
                    max_windows=args.max_windows, device=args.device)},
        "ntt": {"logn": args.ntt_logn,
                "scaling": measure_ntt_scaling(args.ntt_logn, counts,
                                               device=args.device)},
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return res


if __name__ == "__main__":
    main()
