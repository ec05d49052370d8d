"""A Groth16 cell: the program's device prover in a closed loop.

Set-up builds the instance from the seed (`zkbench.generator`), flattens
it and packs the witness pool on the host (the program's
`core.flat.from_arrays` and `pack_witness_values`), runs
`protocols.groth16_device.keygen_device` on the card under the seed's
trapdoor and warms up with proves.  The window hands the prover one
witness at a time from the pool, with fresh (r, s), and waits for the
proof: `prove_device(crs, fc, witness, rng)`, from the host witness
tensor to the proof points on the host.

Probes at the program's seams (`Probes`) keep what the timed path
produced for the judge: the MSM results as the prove unpacks them
(`ops.curve.unpack_g1` / `unpack_g2`) and, for proves sampled from the
seed, the witness reduction's outputs (`engine.torch_engine.
run_witness_reduction`), copied to the host after the prove's latency is
taken.  In a traced run they also time the reduction and the MSMs (from
the first launch to the last result read back), with the card
synchronised at each end, and label the MSMs' host range in profiled
proves (`zkbench.trace.MSM_LABEL`).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import generator, peak, trace
from ..reference import groth16 as ref_mod

WARMUP_PROVES = 2


class Probes:
    """Wrappers around the program's seams, installed for a `with`
    block.  `begin()` / `end()` bracket one prove."""

    def __init__(self, timed: bool, sync, label: bool = False):
        from zukelang_tpu_torch.engine import torch_engine as te
        from zukelang_tpu_torch.ops import curve as C
        from zukelang_tpu_torch.ops import msm as msm_mod
        self.timed, self.label, self.sync = timed, label, sync
        self.cur: Optional[dict] = None
        self._targets = [(te, "run_witness_reduction", self._reduction),
                         (C, "unpack_g1", self._unpack("g1")),
                         (C, "unpack_g2", self._unpack("g2"))]
        if timed or label:
            self._targets += [(msm_mod, name, self._deferred)
                              for name in ("msm_many_staged_deferred",
                                           "msm_staged_deferred")]
        self._saved = []

    def __enter__(self):
        for mod, name, wrap in self._targets:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def begin(self, keep_reduction: bool) -> None:
        self.cur = {"g1": [], "g2": [], "keep": keep_reduction,
                    "reduction": None, "reduction_s": 0.0,
                    "msm_t0": None, "msm_t1": None, "msm_open": 0}

    def end(self) -> dict:
        cur, self.cur = self.cur, None
        if cur["reduction"] is not None:
            cur["reduction"] = tuple(t.cpu().numpy().view(np.uint32)
                                     for t in cur["reduction"])
        return cur

    def _reduction(self, orig):
        def run_witness_reduction(*a, **k):
            cur = self.cur
            if cur is None:
                return orig(*a, **k)
            if self.timed:
                self.sync()
                t0 = time.perf_counter()
            out = orig(*a, **k)
            if self.timed:
                self.sync()
                cur["reduction_s"] += time.perf_counter() - t0
            if cur["keep"]:
                cur["reduction"] = out
            return out
        return run_witness_reduction

    def _unpack(self, group: str):
        def wrap(orig):
            def unpack(p):
                out = orig(p)
                if self.cur is not None:
                    self.cur[group].extend(out)
                return out
            return unpack
        return wrap

    def _deferred(self, orig):
        def launch(*a, **k):
            cur = self.cur
            if cur is None:
                return orig(*a, **k)
            if cur["msm_t0"] is None:
                cur["msm_t0"] = time.perf_counter()
                if self.label:
                    from torch.profiler import record_function
                    cur["msm_range"] = record_function(trace.MSM_LABEL)
                    cur["msm_range"].__enter__()
            cur["msm_open"] += 1
            resolve = orig(*a, **k)

            def resolved():
                out = resolve()
                cur["msm_open"] -= 1
                if cur["msm_open"] == 0:
                    if self.timed:
                        self.sync()
                        cur["msm_t1"] = time.perf_counter()
                    if self.label:
                        cur["msm_range"].__exit__(None, None, None)
                return out
            return resolved
        return launch


def _affine(p):
    """A point of the program -> plain affine ints (None at infinity)."""
    if p.x is None:
        return None
    if hasattr(p.x, "c0"):
        return ((p.x.c0.n, p.x.c1.n), (p.y.c0.n, p.y.c1.n))
    return (p.x.n, p.y.n)


class Cell:
    """The program's side of a Groth16 cell on `device`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from zukelang_tpu_torch.core import flat
        from zukelang_tpu_torch.protocols import groth16_device as gd
        from zukelang_tpu_torch.rng import InjectedRng
        self.gd, self.InjectedRng = gd, InjectedRng
        self.device = torch.device(device)
        self.config, self.traffic = config, traffic
        self.inst = inst = generator.build(config, traffic, seed)
        G = len(inst.gates[0])
        ones = [[1]] * G
        self.fc = flat.from_arrays(
            inst.n_vars, inst.logn,
            *[(g.reshape(G, 1), ones) for g in inst.gates])
        self.pool = [flat.pack_witness_values(w) for w in inst.witnesses]
        t0 = time.perf_counter()
        self.crs, self.vkey = gd.keygen_device(
            self.fc, mids=inst.mids.tolist(), ios=inst.ios.tolist(),
            rng=InjectedRng(list(inst.trapdoor)), device=self.device)
        self.sync()
        self.keygen_s = time.perf_counter() - t0
        self.scalars = inst.proof_scalars()
        self.count = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prove(self, probes: Optional[Probes] = None,
              keep_reduction: bool = False) -> dict:
        """One prove of the next witness of the pool -> its record: the
        witness, (r, s), the latency, the proof, and what the probes kept."""
        widx = self.count % len(self.pool)
        r, s = next(self.scalars)
        self.count += 1
        if probes is not None:
            probes.begin(keep_reduction)
        t0 = time.perf_counter()
        proof = self.gd.prove_device(self.crs, self.fc, self.pool[widx],
                                     self.InjectedRng([r, s]))
        t1 = time.perf_counter()
        rec = {"widx": widx, "r": r, "s": s, "latency_s": t1 - t0,
               "proof": proof}
        if probes is not None:
            rec.update(probes.end())
        return rec

    def msm_terms(self) -> dict:
        n = 1 << self.inst.logn
        return {"g1": [n, n, n - 1, len(self.inst.mids)], "g2": [n]}

    def close(self) -> None:
        """Free the program's state on the card."""
        self.crs = self.vkey = self.fc = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(cell: Cell, seconds: float, timed: bool) -> dict:
    """Proves back to back for `seconds` (the last one runs to its end)."""
    sample = set(cell.inst.sample())
    proofs: List[dict] = []
    with Probes(timed, cell.sync) as probes:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while time.perf_counter() < deadline:
            proofs.append(cell.prove(probes, keep_reduction=i in sample))
            i += 1
        t_end = time.perf_counter()
        if not any(p["reduction"] is not None for p in proofs):
            # fewer proves than the sample's range: keep the next one
            proofs.append(cell.prove(probes, keep_reduction=True))
            proofs[-1]["after_window"] = True
    return {"proofs": proofs, "window_s": t_end - t_start}


def run(config: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
        device, t_process: float) -> dict:
    """One run of a cell -> its record (see `zkbench.harness`)."""
    cell = Cell(config, traffic, seed, device)
    with Probes(False, cell.sync) as probes:
        for _ in range(WARMUP_PROVES):
            cell.prove(probes)
    cell.sync()
    gc.collect()        # set-up's garbage, not collected inside the window
    cuda = cell.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    setup_s = time.perf_counter() - t_process
    win = window(cell, seconds, timed=trace_on)
    window_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    rec = {"setup_s": setup_s, "keygen_s": cell.keygen_s,
           "window_s": win["window_s"],
           "latencies_s": [p["latency_s"] for p in win["proofs"]
                           if not p.get("after_window")],
           "window_peak_bytes": window_peak,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "msm_terms": cell.msm_terms()}
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
        with Probes(False, cell.sync, label=True) as probes:
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
    rec["checks"] = judge(config, inst, proofs)
    return rec


def judge(config: dict, inst, proofs: List[dict]) -> dict:
    """Every proof of the run against the plain reference."""
    ref = ref_mod.for_instance(config, inst)
    plain = []
    for p in proofs:
        entry = {"widx": p["widx"], "r": p["r"], "s": p["s"],
                 "proof": tuple(_affine(getattr(p["proof"], k))
                                for k in "abc"),
                 "g1": [_affine(q) for q in p.get("g1", [])],
                 "g2": [_affine(q) for q in p.get("g2", [])]}
        if p.get("reduction") is not None:
            entry["reduction"] = ref.reduction_values(*p["reduction"])
        plain.append(entry)
    return ref_mod.judge(ref, plain)
