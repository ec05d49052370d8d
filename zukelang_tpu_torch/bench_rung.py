"""One benchmark rung as a process of its own (a child of `bench`).

Counterpart of `zukelang_tpu/bench_rung.py`.  Runs one protocol at one
size through keygen, prove and verify (`bench_lib`) on the card and
writes the result record as JSON to --out.  Stage progress is written to
the same file as each stage ends, so the parent can say how far a rung
got when it had to kill it at its wall timeout.

    python -m zukelang_tpu_torch.bench_rung --proto groth16 --logn 20 \
        --repeats 3 --out r.json

The record is also printed as one JSON line on stdout.  The exit code is
0 for a record with a time, 1 for an error record (`value` -1); without
a CUDA device the rung refuses to run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback


class _FlushingProgress(dict):
    """Progress dict that writes itself to `path` on every update."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        _atomic_write(self._path, {"done": False, "progress": dict(self)})


def _atomic_write(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _stage_reached(progress) -> str:
    order = ["build_r1cs_s", "keygen_s", "prove_first_s", "prove_s",
             "verify_s"]
    done = [k for k in order if k in progress]
    return done[-1] if done else "start"


def _ref_cost_s(n: int, msm_terms: int) -> float:
    """Modeled, not measured: the cost of the reference prover
    (camlspotter/zukelang, one CPU core, blst-class primitives) at the
    same size, copied from the JAX package's model.  One 0.25 ms
    scalar multiplication per MSM term (curve.ml:94-103) plus n^2 Fr
    products at 30 ns (polynomial product and long division,
    QAP.ml:120-135).  It under-counts the reference's O(n^2) Lagrange
    interpolation, so `vs_baseline` (this cost / prove_s) is
    conservative."""
    return msm_terms * 0.25e-3 + (n ** 2) * 30e-9


def run_rung(proto: str, log_n: int, repeats: int, progress: dict,
             device=None) -> dict:
    """Run one rung on `device` (default: the card) -> the result record
    (the JAX package's shape, with the backend and the card in
    `detail`), or an error record with `value` -1."""
    from . import bench_lib

    name = f"{proto}_prove_2^{log_n}"
    t0 = time.time()
    try:
        if proto == "groth16":
            res = bench_lib.bench_groth16(log_n, repeats=repeats,
                                          progress=progress, device=device)
        else:
            res = bench_lib.bench_pinocchio(log_n, repeats=repeats,
                                            progress=progress, device=device)
    except Exception as e:
        err = f"{type(e).__name__}: {e}"
        print(f"[bench] {name} failed after {_stage_reached(progress)}: "
              f"{err}\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        return {"metric": name, "value": -1, "unit": "s", "vs_baseline": 0,
                "error": err[:300],
                "detail": {"stage_reached": _stage_reached(progress),
                           "stage_timings": dict(progress)}}

    return rung_record(name, log_n, res, time.time() - t0, device)


def rung_record(name: str, log_n: int, res: dict, wall_s: float,
                device=None) -> dict:
    """The record of a rung that completed, from the `bench_lib` dict."""
    vs = _ref_cost_s(1 << log_n, res["msm_terms_per_prove"]) / res["prove_s"]
    return {
        "metric": name,
        "value": round(res["prove_s"], 4),
        "unit": "s",
        "vs_baseline": round(vs, 2),
        "detail": {
            "domain_log": res.get("domain_log", log_n),
            "keygen_s": round(res["keygen_s"], 3),
            "prove_first_s": round(res["prove_first_s"], 3),
            "prove_s": round(res["prove_s"], 4),
            "verify_s": round(res["verify_s"], 3),
            "msm_mterms_per_s": round(res["msm_mops_per_s"], 3),
            "verified": res["verified"],
            "rung_wall_s": round(wall_s, 1),
            "backend": "torch-cuda",
            "device": _device_line(device),
        },
    }


def _device_line(device) -> str:
    """The card's name and power limit (`timing.card_line`), or the
    device's name where the run was not on the card."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return str(device)
    from .timing import card_line
    return card_line()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proto", choices=["groth16", "pinocchio"],
                    required=True)
    ap.add_argument("--logn", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_rung: needs a CUDA device")

    progress = _FlushingProgress(args.out)
    rec = run_rung(args.proto, args.logn, args.repeats, progress)
    _atomic_write(args.out, {"done": True, "record": rec,
                             "progress": dict(progress)})
    print(json.dumps(rec), flush=True)
    return 0 if rec["value"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
