"""The control of a Pinocchio cell's correctness check: the plain
reference put in the program's place with a guarantee of the
configuration broken, judged as a run is.  It has to come out as not
correct.

As `zkbench.control` does for Groth16: the configuration states exact
arithmetic in Fr (255-bit scalars), and the control is the reference
prover in a narrower field element, every witness value cut to its low
WIDTH bits before the prover uses it.  It presents what a run's probes
keep, for as many proves as a run of the cell makes: the ten MSM
results, the proof, and the reduction's values at s.

    python3 -m zkbench.control_pinocchio --workload <name> --seeds 1 2 3 \
        [--proofs N]

Runs on the host alone (no device); prints one JSON line a seed and
exits 1 if any seed's control came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import generator, harness
from .protocols.pinocchio import blinding, pad
from .reference import pinocchio as ref_mod

R = ref_mod.R
WIDTH = 128


def held_columns(inst) -> int:
    """The columns a key of the rung holds on the card: the domain's
    width (the rest are tails)."""
    return min(inst.n_vars, 1 << inst.logn)


def control_proofs(config: dict, inst, coefs, count: int) -> list:
    """`count` proves of the narrowed reference prover, as a run's records
    (plain: affine points and reduction values)."""
    mask = (1 << WIDTH) - 1
    narrow = ref_mod.for_instance(
        config, inst, coefs, held_columns(inst),
        [[v & mask for v in w] for w in inst.witnesses])
    ds = blinding(inst.seed)
    sample = set(inst.sample())
    out = []
    for i in range(count):
        widx = i % len(inst.witnesses)
        d = next(ds)
        msm = narrow.msm_points(widx)
        sc = narrow.scalars(widx)
        p = {"widx": widx, "d": d, "proof": narrow.proof_points(widx, d),
             "g1": msm["g1"], "g2": msm["g2"]}
        if i in sample:
            p["reduction"] = (sc["V"], sc["W"], sc["H"], 0)
        out.append(p)
    return out


def run_control(bench: dict, workload: str, seed: int, proofs: int,
                root: str = ".") -> dict:
    _cell, config, traffic = harness.cell_parts(bench, workload, root)
    t0 = time.perf_counter()
    inst, coefs = pad(config, generator.build(config, traffic, seed))
    ref = ref_mod.for_instance(config, inst, coefs, held_columns(inst))
    counts = ref_mod.judge(ref, control_proofs(config, inst, coefs, proofs))
    chk = harness.checks(config, counts)
    return {"workload": workload, "seed": seed, "width": WIDTH,
            "correct": all(c["ok"] for c in chk.values()),
            "checks": {k: c["value"] for k, c in chk.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--proofs", type=int, default=100)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    any_correct = False
    for seed in args.seeds:
        res = run_control(bench, args.workload, seed, args.proofs)
        any_correct |= res["correct"]
        print(json.dumps(res), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
