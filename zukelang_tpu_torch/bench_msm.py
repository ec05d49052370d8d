"""Standalone MSM micro-benchmark.

The port's counterpart of `scripts/bench_msm.py`.  Usage:

    python -m zukelang_tpu_torch.bench_msm [logN] [c ...] [--no-jac]
        [--no-affine] [--device cpu]

Times `msm_staged` for G1 at 2^logN (default 18) random terms for each
window width given (default: `msm.auto_window`), on Jacobian bases (the
window program's log-depth K2 scan) and on the same bases made affine
(the v2 pipeline).  Each variant runs once to warm up, then three times;
the line gives the minimum of the three from `timing.time_ms` (CUDA
events on the card) and the first call by the host clock.  At logN <= 12
every result is held against golden `G1.dot` and the line ends in OK; a
mismatch raises.  Runs on the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import params
from .engine.torch_engine import checked_device
from .golden.curve import G1
from .golden.field import Fr
from .ops import curve as C
from .ops import field as F
from .ops import msm
from .params import FR
from .timing import time_ms


def rand_points_device(n: int, device, seed: int = 7):
    """Pseudo-random G1 batch built on the device: k*G for small random k
    by fixed-base multiplication, avoiding n golden scalar-mults on the
    host.  -> (Jacobian batch, the ks)."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    pts = msm.fixed_base_mul(F.pack(ks, FR, device), group="g1")
    return pts, ks


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m zukelang_tpu_torch.bench_msm")
    ap.add_argument("logn", nargs="?", type=int, default=18)
    ap.add_argument("cs", nargs="*", type=int)
    ap.add_argument("--no-jac", action="store_true")
    ap.add_argument("--no-affine", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark and print its lines; -> {"results": {(variant, c):
    golden point}, "points": the Jacobian bases, "affine": the affine ones
    (None with --no-affine), "scalars": the scalar ints, "scalars_std":
    their (8, N) limbs, "ks": the bases' multipliers, "seconds": {(variant,
    c): (warm minimum, first)}}."""
    args = _parse(argv)
    dev = checked_device(args.device)
    logn, cs = args.logn, args.cs or [None]
    n = 1 << logn

    rng = np.random.RandomState(11)
    scalars = [int.from_bytes(rng.bytes(32), "little") % params.R
               for _ in range(n)]
    S = F.pack(scalars, FR, dev)

    t0 = time.time()
    P, ks = rand_points_device(n, dev)
    _sync(dev)
    print(f"point gen: {time.time() - t0:.2f}s", flush=True)

    expected = None
    if logn <= 12:
        g = G1.generator()
        expected = G1.dot([g * k for k in ks], [Fr(s) for s in scalars])

    variants = [] if args.no_jac else [("jac", P)]
    Paff = None
    if not args.no_affine:
        t0 = time.time()
        Paff = C.to_affine(P)
        _sync(dev)
        print(f"to_affine: {time.time() - t0:.2f}s", flush=True)
        variants.append(("aff", Paff))

    results, seconds = {}, {}
    for c in cs:
        ceff = c if c is not None else msm.auto_window(n)
        for tag, pts in variants:
            first = []

            def run():
                t0 = time.time()
                r = msm.msm_staged(pts, S, group="g1", c=ceff)
                if not first:       # time_ms's warm-up call
                    first.append(time.time() - t0)
                return r

            ms, r = time_ms(run, dev, reps=3, stat="min")
            t = ms / 1e3
            if expected is not None and r != expected:
                raise AssertionError(f"G1 MSM[{tag}] 2^{logn} c={ceff}: "
                                     "differs from golden G1.dot")
            ok = "" if expected is None else " OK"
            print(f"G1 MSM[{tag}] 2^{logn} c={ceff}: {t:.3f}s warm "
                  f"({n / t / 1e6:.2f} Mterm/s), first {first[0]:.1f}s{ok}",
                  flush=True)
            results[(tag, ceff)] = r
            seconds[(tag, ceff)] = (t, first[0])
    return {"results": results, "points": P, "affine": Paff,
            "scalars": scalars, "scalars_std": S, "ks": ks,
            "seconds": seconds}


if __name__ == "__main__":
    main()
