"""The control of the correctness check of a ragged-row Groth16 cell
(`zkbench.protocols.groth16_r1cs`): the plain reference put in the
program's place with the configuration's exact arithmetic broken, judged
as a run is.  Each fault has to come out as not correct.

  cut    every witness value cut to its low WIDTH bits before the prover
         uses it (`zkbench.control`'s narrower scalar path).  The bit
         columns keep their values, so only the full-width ones differ;
  flip   one column that is 0 or 1 in every witness of the pool, drawn
         from the seed, flipped: a step that loses or inverts a bit.

It presents what a run's probes keep, for as many proves as a run makes:
the five MSM results, the proof, and the reduction's values at tau.

    python3 -m zkbench.control_groth16_r1cs --workload <name> \
        --seeds 1 2 3 [--proofs N]

Runs on the host alone (no device); prints one JSON line a seed and fault
and exits 1 if any came out correct.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from . import circuits_sapling, harness
from .reference import groth16_r1cs as ref_mod

R = ref_mod.R
WIDTH = 128
FAULTS = ("cut", "flip")


def faulty_witnesses(inst, fault: str) -> tuple:
    """The pool as the faulty prover sees it -> (witnesses, what changed)."""
    if fault == "cut":
        mask = (1 << WIDTH) - 1
        return [[v & mask for v in w] for w in inst.witnesses], WIDTH
    bits = [c for c in inst.mids.tolist()
            if all(w[c] in (0, 1) for w in inst.witnesses)]
    col = random.Random(f"zkbench/{inst.seed}/flip").choice(bits)
    out = [list(w) for w in inst.witnesses]
    for w in out:
        w[col] ^= 1
    return out, col


def control_proofs(faulty, inst, count: int) -> list:
    """`count` proves of the faulty reference prover, as a run's records
    (plain: affine points and reduction values)."""
    zinv = pow(faulty.z_tau, -1, R)
    scalars = inst.proof_scalars()
    sample = set(inst.sample())
    out = []
    for i in range(count):
        widx = i % len(inst.witnesses)
        r, s = next(scalars)
        msm = faulty.msm_points(widx)
        sc = faulty.scalars(widx)
        p = {"widx": widx, "r": r, "s": s,
             "proof": faulty.proof_points(widx, r, s),
             "g1": msm["g1"], "g2": msm["g2"]}
        if i in sample:
            p["reduction"] = (sc["A"], sc["B"],
                              (sc["A"] * sc["B"] - sc["C"]) * zinv % R, 0)
        out.append(p)
    return out


def run_control(bench: dict, workload: str, seed: int, proofs: int,
                fault: str, root: str = ".") -> dict:
    _cell, config, traffic = harness.cell_parts(bench, workload, root)
    t0 = time.perf_counter()
    inst = circuits_sapling.build(config, traffic, seed)
    witnesses, changed = faulty_witnesses(inst, fault)
    faulty = ref_mod.for_instance(config, inst, witnesses)
    counts = ref_mod.judge(ref_mod.for_instance(config, inst),
                           control_proofs(faulty, inst, proofs))
    chk = harness.checks(config, counts)
    return {"workload": workload, "seed": seed, "fault": fault,
            "changed": changed,
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
        for fault in FAULTS:
            res = run_control(bench, args.workload, seed, args.proofs, fault)
            any_correct |= res["correct"]
            print(json.dumps(res), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
