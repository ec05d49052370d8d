"""A Groth16 cell over a circuit with ragged rows (`zkbench.circuits_sapling`):
the program's device prover in a closed loop.

Set-up builds the instance from the seed, hands the program's
`core.flat.from_arrays` its ragged rows (offsets, columns, coefficients
of each side) and packs the witness pool on the host
(`pack_witness_values`), runs `protocols.groth16_device.keygen_device` on
the card under the seed's trapdoor with the configuration's public
columns (ONE and 7 inputs) and warms up with proves.  The window, the
probes and the traced proves are the Groth16 cell's
(`zkbench.protocols.groth16`); the traced proves also give the device
time of the witness reduction's NTT kernel launches
(`reduction_device_s` in the record's trace, read by
`reduction_roofline` with the circuit's `reduction_shape`).  The plain
reference of ragged rows (`zkbench.reference.groth16_r1cs`) judges every
proof.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import List
from unittest import mock

import torch

from .. import circuits_sapling, peak, trace
from ..reference import groth16_r1cs as ref_mod
from . import groth16 as g16

REDUCTION_KERNEL = "k_ntt_pass"


class Cell(g16.Cell):
    """The program's side of the cell on `device`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from zukelang_tpu_torch.core import flat
        from zukelang_tpu_torch.protocols import groth16_device as gd
        from zukelang_tpu_torch.rng import InjectedRng
        self.gd, self.InjectedRng = gd, InjectedRng
        self.device = torch.device(device)
        self.config, self.traffic = config, traffic
        self.inst = inst = circuits_sapling.build(config, traffic, seed)
        self.fc = flat.from_arrays(inst.n_vars, inst.logn, *inst.gates)
        self.pool = [flat.pack_witness_values(w) for w in inst.witnesses]
        t0 = time.perf_counter()
        self.crs, self.vkey = gd.keygen_device(
            self.fc, mids=inst.mids.tolist(), ios=inst.ios.tolist(),
            rng=InjectedRng(list(inst.trapdoor)), device=self.device)
        self.sync()
        self.keygen_s = time.perf_counter() - t0
        self.scalars = inst.proof_scalars()
        self.count = 0

    def msm_terms(self) -> dict:
        """The MSMs' terms: a, b and h in full; of the mids' MSM only the
        terms whose scalar is neither 0 nor 1 (the fewest over the pool).
        A scalar of 1 needs one addition, not a window's each: those
        additions (about 32,000, 0.2 % of the count at the Sapling
        shape) are left out, so the share reads low rather than high."""
        n, inst = 1 << self.inst.logn, self.inst
        mids = inst.mids.tolist()
        wide = min(sum(1 for c in mids if w[c] > 1) for w in inst.witnesses)
        return {"g1": [n, n, n - 1, wide], "g2": [n]}

    def reduction_shape(self) -> dict:
        return {"nnz": sum(len(cols) for _o, cols, _c in self.inst.gates),
                "logn": self.inst.logn, "vars": self.inst.n_vars}


def _with_reduction_time(summarise):
    """trace.summarise, plus the union of the device intervals of the
    reduction's kernel over the profiled proves (None where it has no
    launch there)."""
    def wrapped(events):
        out = summarise(events)
        if out is None:
            return None
        proves = [(e.start_ns(), e.end_ns()) for e in events
                  if not trace._is_device(e) and e.name() == trace.PROVE_LABEL]
        lo, hi = min(p[0] for p in proves), max(p[1] for p in proves)
        ntt = [(e.start_ns(), e.end_ns()) for e in events
               if trace._is_device(e) and REDUCTION_KERNEL in e.name()]
        busy = trace.union_seconds(ntt, lo, hi)[0]
        out["reduction_device_s"] = busy / 1e9 if busy else None
        return out
    return wrapped


def run(config: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
        device, t_process: float) -> dict:
    """One run of a cell -> its record (see `zkbench.harness`)."""
    cell = Cell(config, traffic, seed, device)
    with g16.Probes(False, cell.sync) as probes:
        for _ in range(g16.WARMUP_PROVES):
            cell.prove(probes)
    cell.sync()
    gc.collect()        # set-up's garbage, not collected inside the window
    cuda = cell.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    setup_s = time.perf_counter() - t_process
    win = g16.window(cell, seconds, timed=trace_on)
    window_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    rec = {"setup_s": setup_s, "keygen_s": cell.keygen_s,
           "window_s": win["window_s"],
           "latencies_s": [p["latency_s"] for p in win["proofs"]
                           if not p.get("after_window")],
           "window_peak_bytes": window_peak,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "msm_terms": cell.msm_terms(),
           "reduction_shape": cell.reduction_shape()}
    proofs = win["proofs"]
    if trace_on:
        timed = [p for p in proofs if p["msm_t0"] is not None
                 and p["msm_t1"] is not None and not p.get("after_window")]
        rec["spans"] = {
            "prove_s": [p["latency_s"] for p in timed],
            "reduction_s": [p["reduction_s"] for p in timed],
            "msm_s": [p["msm_t1"] - p["msm_t0"] for p in timed]}
        profiled: List[dict] = []

        def one():
            profiled.append(cell.prove(probes))
        with g16.Probes(False, cell.sync, label=True) as probes, \
                mock.patch.object(trace, "summarise",
                                  _with_reduction_time(trace.summarise)):
            trace.profile(one, 1, cell.sync)         # the profiler's own start
            profiled.clear()
            rec["trace"] = trace.profile_complete(one, sync=cell.sync)
        proofs = proofs + profiled
        if cuda:
            rec["peak_limb_products_per_s"] = peak.limb_products_per_s(
                cell.device)
            print("zkbench.peak: limb products/s",
                  rec["peak_limb_products_per_s"], file=sys.stderr)
    inst = cell.inst
    cell.close()
    rec["attempted"] = len(proofs)
    t0 = time.perf_counter()
    rec["checks"] = judge(config, inst, proofs)
    print(f"zkbench.groth16_r1cs: judged {len(proofs)} proofs in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return rec


def judge(config: dict, inst, proofs: List[dict]) -> dict:
    """Every proof of the run against the plain reference."""
    ref = ref_mod.for_instance(config, inst)
    plain = []
    for p in proofs:
        entry = {"widx": p["widx"], "r": p["r"], "s": p["s"],
                 "proof": tuple(g16._affine(getattr(p["proof"], k))
                                for k in "abc"),
                 "g1": [g16._affine(q) for q in p.get("g1", [])],
                 "g2": [g16._affine(q) for q in p.get("g2", [])]}
        if p.get("reduction") is not None:
            entry["reduction"] = ref.reduction_values(*p["reduction"])
        plain.append(entry)
    return ref_mod.judge(ref, plain)
