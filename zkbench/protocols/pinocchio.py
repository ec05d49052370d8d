"""A Pinocchio cell: the program's device prover in a closed loop.

Set-up builds the instance from the seed (`zkbench.generator`) and pads
it here to the configuration's rung (`pad`): the chain's gates and
columns, then gates 0 = 0 * 0 of coefficient 0 up to the domain and
zero-valued mid columns up to `vars`, as the program's synthetic bench
pads its rungs (`bench_lib.make_synthetic_r1cs(..., pad_log)`).  It
flattens the instance and packs the witness pool on the host (the
program's `core.flat.from_arrays` and `pack_witness_values`), runs
`protocols.pinocchio_device.keygen_device` on the card under the seed's
trapdoor (rv, rw, s, av, aw, ay, b, gm, keygen's own order) and warms up
with proves.  The window hands the prover one witness at a time from the
pool, with fresh (dv, dw, dy) from the seed, and waits for the proof:
`prove_device(pkey, fc, witness, rng, zk)`, from the host witness tensor
to the eight proof points on the host.

The probes, the window and the traced proves are the Groth16 cell's
(`zkbench.protocols.groth16`): the MSM results as the prove unpacks them,
the witness reduction's outputs of proves sampled from the seed, and in
a traced run the reduction's and the MSMs' spans.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import generator, peak, trace
from ..reference import pinocchio as ref_mod
from .groth16 import WARMUP_PROVES, Probes, _affine, window

R = ref_mod.R


def pad(config: dict, inst: generator.Instance):
    """The generator's chain padded to the rung -> (instance, coefs): the
    gates padded with (0, 0, 0) up to the domain, each gate's coefficient
    (1 on the chain, 0 on the padding), zero-valued mid columns appended
    up to `vars`, and the trapdoor rv, rw, s, av, aw, ay, b, gm drawn from
    the seed with s off the domain."""
    n, V = 1 << inst.logn, int(config["vars"])
    G = len(inst.gates[0])
    if V < inst.n_vars:
        raise ValueError(f"{V} columns hold fewer than the chain's "
                         f"{inst.n_vars}")
    gates = tuple(np.concatenate([g, np.zeros(n - G, dtype=np.int64)])
                  for g in inst.gates)
    coefs = np.concatenate([np.ones(G, dtype=np.int64),
                            np.zeros(n - G, dtype=np.int64)])
    mids = np.concatenate([inst.mids, np.arange(inst.n_vars, V,
                                                dtype=np.int64)])
    zeros = [0] * (V - inst.n_vars)
    trng = random.Random(f"zkbench/{inst.seed}/pinocchio-crs")
    while True:
        trapdoor = tuple(1 + trng.randrange(R - 1) for _ in range(8))
        if pow(trapdoor[2], n, R) != 1:      # s off the domain
            break
    padded = dataclasses.replace(
        inst, n_vars=V, gates=gates, mids=mids, trapdoor=trapdoor,
        witnesses=[w + zeros for w in inst.witnesses])
    return padded, coefs


def blinding(seed: int):
    """The (dv, dw, dy) of each prove in turn: an endless iterator."""
    rnd = random.Random(f"zkbench/{seed}/pinocchio-prove")
    while True:
        yield tuple(1 + rnd.randrange(R - 1) for _ in range(3))


class Cell:
    """The program's side of a Pinocchio cell on `device`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from zukelang_tpu_torch.core import flat
        from zukelang_tpu_torch.protocols import pinocchio_device as pd
        from zukelang_tpu_torch.rng import InjectedRng
        self.pd, self.InjectedRng = pd, InjectedRng
        self.device = torch.device(device)
        self.config = config
        self.zk = bool(config["zk"])
        self.inst, self.coefs = inst, coefs = pad(
            config, generator.build(config, traffic, seed))
        coef_rows = coefs.reshape(-1, 1).tolist()
        self.fc = flat.from_arrays(
            inst.n_vars, inst.logn,
            *[(g.reshape(-1, 1), coef_rows) for g in inst.gates])
        self.pool = [flat.pack_witness_values(w) for w in inst.witnesses]
        t0 = time.perf_counter()
        self.pkey, self.vkey = pd.keygen_device(
            self.fc, mids=inst.mids.tolist(), ios=inst.ios.tolist(),
            rng=InjectedRng(list(inst.trapdoor)), device=self.device)
        self.sync()
        self.keygen_s = time.perf_counter() - t0
        self.held = inst.n_vars - len(self.pkey.v_all_tail)
        self.scalars = blinding(seed)
        self.count = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prove(self, probes: Optional[Probes] = None,
              keep_reduction: bool = False) -> dict:
        """One prove of the next witness of the pool -> its record: the
        witness, (dv, dw, dy), the latency, the proof, and what the probes
        kept."""
        widx = self.count % len(self.pool)
        d = next(self.scalars)
        self.count += 1
        if probes is not None:
            probes.begin(keep_reduction)
        t0 = time.perf_counter()
        proof = self.pd.prove_device(self.pkey, self.fc, self.pool[widx],
                                     self.InjectedRng(list(d)), zk=self.zk)
        t1 = time.perf_counter()
        rec = {"widx": widx, "d": d, "latency_s": t1 - t0, "proof": proof}
        if probes is not None:
            rec.update(probes.end())
        return rec

    def msm_terms(self, proofs: List[dict]) -> dict:
        """The terms of a prove's MSMs whose scalar is not zero: the mids'
        and the held columns' witness values (the fewest over the pool),
        and h's first N - 1 coefficients (the fewest over the reductions
        the probes kept)."""
        inst, n = self.inst, 1 << self.inst.logn
        mid = min(sum(1 for c in inst.mids if w[c]) for w in inst.witnesses)
        held = min(sum(1 for v in w[:self.held] if v)
                   for w in inst.witnesses)
        h = min((int(np.count_nonzero(p["reduction"][2][:, :n - 1].any(0)))
                 for p in proofs if p.get("reduction") is not None),
                default=n - 1)
        g1 = [mid, mid, h, mid, mid, mid] + ([held, held] if self.zk else [])
        return {"g1": g1, "g2": [mid, mid]}

    def close(self) -> None:
        """Free the program's state on the card."""
        self.pkey = self.vkey = self.fc = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


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
    proofs = win["proofs"]
    rec = {"setup_s": setup_s, "keygen_s": cell.keygen_s,
           "window_s": win["window_s"],
           "latencies_s": [p["latency_s"] for p in proofs
                           if not p.get("after_window")],
           "window_peak_bytes": window_peak,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "msm_terms": cell.msm_terms(proofs)}
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
    inst, coefs, held = cell.inst, cell.coefs, cell.held
    cell.close()
    rec["attempted"] = len(proofs)
    t0 = time.perf_counter()
    rec["checks"] = judge(config, inst, coefs, held, proofs)
    rec["judge_s"] = time.perf_counter() - t0
    print(f"zkbench.pinocchio: judged {len(proofs)} proofs in "
          f"{rec['judge_s']:.2f} s", file=sys.stderr)
    return rec


def judge(config: dict, inst, coefs, held: int, proofs: List[dict]) -> dict:
    """Every proof of the run against the plain reference."""
    ref = ref_mod.for_instance(config, inst, coefs, held)
    plain = []
    for p in proofs:
        entry = {"widx": p["widx"], "d": p["d"],
                 "proof": tuple(_affine(getattr(p["proof"], k))
                                for k in ref_mod.PROOF),
                 "g1": [_affine(q) for q in p.get("g1", [])],
                 "g2": [_affine(q) for q in p.get("g2", [])]}
        if p.get("reduction") is not None:
            entry["reduction"] = ref.reduction_values(*p["reduction"])
        plain.append(entry)
    return ref_mod.judge(ref, plain)
