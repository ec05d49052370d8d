"""Synthetic R1CS instances and the Groth16 and Pinocchio bench runs.

Counterpart of `zukelang_tpu.bench_lib`: `make_synthetic_r1cs`,
`canon_pad_log`, `bench_groth16` and `bench_pinocchio`.  The same seed
gives the same instance: the same gate indices, witness values and
mids/ios partition.  `run_groth16` / `run_pinocchio` return what a run
did (keypair, last proof, stage times, launches, peak device memory);
`bench_groth16` / `bench_pinocchio` return the JAX package's dict.  A
`progress` dict, where given, is updated in place as each stage ends
(`build_r1cs_s`, `keygen_s`, `prove_first_s`, `prove_s`, `verify_s`),
so a run that fails still says how far it got (`bench_rung`).

Instance shape: a multiplicative chain.  w_0 = 1 (ONE), w_1 = x secret;
gate g asserts w_{g+2} = w_{a_g} * w_{b_g} with a_g, b_g < g+2 drawn
at random.  One public output (the last wire).  `pad_log` pads the domain
with 0 = 0*0 gates and zero-valued dummy mid variables.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import params
from .core import flat as flat_mod


@dataclass
class SyntheticR1CS:
    fc: flat_mod.FlatCircuit
    witness: List[int]          # values per var column (ints mod r)
    mids_cols: np.ndarray
    ios_cols: np.ndarray

    def pack_witness(self, device=None) -> torch.Tensor:
        return flat_mod.pack_witness_values(self.witness, device)


def make_synthetic_r1cs(log_constraints: int, seed: int = 1,
                        pad_log: int = None) -> SyntheticR1CS:
    rng = np.random.RandomState(seed)
    G = 1 << log_constraints
    if pad_log is None or pad_log < log_constraints:
        pad_log = log_constraints
    Gp = 1 << pad_log
    V = G + 2
    Vp = Gp + 2
    r = params.R

    his = np.arange(2, G + 2, dtype=np.float64)
    a_idx = np.minimum((rng.random_sample(G) * his).astype(np.int64), G + 1)
    b_idx = np.minimum((rng.random_sample(G) * his).astype(np.int64), G + 1)

    w = [0] * Vp
    w[0] = 1
    w[1] = int.from_bytes(rng.bytes(32), "little") % r
    for g in range(G):
        w[g + 2] = w[a_idx[g]] * w[b_idx[g]] % r

    def side(idx_arr):
        # pad gates reference var 0 with coefficient 0 (affine combo = 0)
        idx_p = np.concatenate([idx_arr, np.zeros(Gp - G, dtype=np.int64)])
        coefs = [[1]] * G + [[0]] * (Gp - G)
        return idx_p.reshape(Gp, 1), coefs

    fc = flat_mod.from_arrays(Vp, pad_log, l=side(a_idx), r=side(b_idx),
                              lhs=side(np.arange(2, G + 2, dtype=np.int64)))
    ios = np.array([0, V - 1], dtype=np.int32)
    mids = np.array([i for i in range(1, Vp) if i != V - 1], dtype=np.int32)
    return SyntheticR1CS(fc=fc, witness=w, mids_cols=mids, ios_cols=ios)


def canon_pad_log(log_constraints: int) -> int:
    """Sizes below 2^BENCH_CANON_LOG (default 16) are padded up to it."""
    canon = int(os.environ.get("BENCH_CANON_LOG", "16"))
    return max(log_constraints, canon)


class _Stages:
    """Stage times of one run on `device`: each stage's seconds on the
    host clock, ended by a synchronisation of the card; the launches of
    every kernel and the peak device memory (MB, None off the card)
    within a stage; `progress` updated as each stage ends."""

    def __init__(self, device: torch.device, progress: Optional[dict]):
        if device.type == "cuda":
            torch.cuda.init()      # the peak-memory counters need it
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.progress = progress if progress is not None else {}
        self.launches: Dict[str, int] = {}
        self.peak_mb: Optional[float] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, fn):
        """-> (fn(), seconds); sets `launches` and `peak_mb` of the call."""
        from .ops import kernels as K
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        before = dict(K.LAUNCHES)
        t0 = time.time()
        out = fn()
        self.sync()
        seconds = time.time() - t0
        self.launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        self.peak_mb = (torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                        if cuda else None)
        return out, seconds

    def done(self, key: str, seconds: float, digits: int = 3) -> None:
        self.progress[key] = round(seconds, digits)


def _build(log_constraints: int, seed: int, st: _Stages) -> SyntheticR1CS:
    t0 = time.time()
    inst = make_synthetic_r1cs(log_constraints, seed,
                               pad_log=canon_pad_log(log_constraints))
    st.done("build_r1cs_s", time.time() - t0)
    return inst


@dataclass
class Groth16Run:
    """What `run_groth16` did: the instance, the keypair, the last proof,
    each stage's time, the launches of every kernel in keygen and in the
    last warm prove, and the peak device memory of keygen and of the warm
    proves (MB; None on the CPU).  `keygen_s` is the time of loading the
    keypair where it came from a checkpoint."""
    log_constraints: int
    inst: SyntheticR1CS
    crs: object
    vkey: object
    witness: torch.Tensor
    public: dict
    proof: object
    build_r1cs_s: float
    keygen_s: float
    keygen_launches: dict
    keygen_peak_mb: Optional[float]
    prove_first_s: float
    warm_s: List[float]
    prove_launches: dict
    prove_peak_mb: Optional[float]
    verify_s: float
    verified: bool
    resumed_from_checkpoint: bool

    def record(self) -> dict:
        """The dict of the JAX package's `bench_groth16`."""
        n = 1 << self.log_constraints
        prove_s = min(self.warm_s)
        # MSM throughput: a prove does 3 G1 MSMs of n, 1 G1 of n-1, 1 of
        # |mids| and 1 G2 MSM of n; G1-equivalent terms (G2 add ~ 3x G1)
        msm_terms = 4 * n + len(self.inst.mids_cols) + 3 * n
        return {
            "log_constraints": self.log_constraints,
            "domain_log": self.inst.fc.logn,
            "keygen_s": self.keygen_s,
            "prove_first_s": self.prove_first_s,
            "prove_s": prove_s,
            "verify_s": self.verify_s,
            "msm_terms_per_prove": msm_terms,
            "msm_mops_per_s": msm_terms / prove_s / 1e6,
            "verified": self.verified,
        }


def _checkpoint_path() -> Optional[str]:
    """ZUKELANG_CRS_CHECKPOINT, with the .npz the keypair file takes."""
    ckpt = os.environ.get("ZUKELANG_CRS_CHECKPOINT")
    if ckpt and not ckpt.endswith(".npz"):
        ckpt += ".npz"
    return ckpt or None


def run_groth16(log_constraints: int, seed: int = 1, repeats: int = 3,
                device=None, progress: dict = None) -> Groth16Run:
    """Groth16 on the synthetic R1CS, as the JAX package's `bench_groth16`
    runs it: keygen, one cold and `repeats` warm proves, verify.  Runs on
    `device` (default: the card); raises if the proof does not verify.

    With ZUKELANG_CRS_CHECKPOINT set, a keypair file there (this port's or
    the JAX package's `save_keypair`) is loaded in place of keygen, and a
    run that keygens writes it."""
    from .golden.field import Fr
    from .engine.torch_engine import checked_device
    from .protocols import groth16_device as gd
    from .rng import Gen

    device = checked_device(device)
    st = _Stages(device, progress)
    inst = _build(log_constraints, seed, st)
    fc = inst.fc
    build_r1cs_s = st.progress["build_r1cs_s"]

    ckpt = _checkpoint_path()
    resumed = bool(ckpt and os.path.exists(ckpt))
    if resumed:
        (crs, vkey), keygen_s = st.run(
            lambda: gd.load_keypair(ckpt, fc, device))
        st.progress["resumed_from_checkpoint"] = True
    else:
        (crs, vkey), keygen_s = st.run(lambda: gd.keygen_device(
            fc, mids=list(inst.mids_cols), ios=list(inst.ios_cols),
            rng=Gen(b"bench-keygen"), device=device))
    keygen_launches, keygen_peak_mb = st.launches, st.peak_mb
    if ckpt and not resumed:
        gd.save_keypair(ckpt, crs, vkey)
    st.done("keygen_s", keygen_s)

    wm = inst.pack_witness(device)
    proof, prove_first_s = st.run(
        lambda: gd.prove_device(crs, fc, wm, Gen(b"bench-prove")))
    st.done("prove_first_s", prove_first_s)
    times, peaks = [], []
    for i in range(repeats):
        proof, t = st.run(lambda: gd.prove_device(
            crs, fc, wm, Gen(b"bench-prove-%d" % i)))
        times.append(t)
        peaks.append(st.peak_mb)
    st.done("prove_s", min(times), 4)

    t0 = time.time()
    public = {int(c): Fr(inst.witness[c]) for c in inst.ios_cols}
    ok = gd.verify(public, vkey, proof)
    verify_s = time.time() - t0
    st.done("verify_s", verify_s)
    if not ok:
        raise AssertionError("benchmark proof failed to verify")
    return Groth16Run(
        log_constraints=log_constraints, inst=inst, crs=crs, vkey=vkey,
        witness=wm, public=public, proof=proof, build_r1cs_s=build_r1cs_s,
        keygen_s=keygen_s, keygen_launches=keygen_launches,
        keygen_peak_mb=keygen_peak_mb, prove_first_s=prove_first_s,
        warm_s=times, prove_launches=st.launches,
        prove_peak_mb=max(peaks) if device.type == "cuda" else None,
        verify_s=verify_s, verified=ok, resumed_from_checkpoint=resumed)


def bench_groth16(log_constraints: int, seed: int = 1, repeats: int = 3,
                  progress: dict = None, device=None) -> dict:
    """`run_groth16`, returning the JAX package's `bench_groth16` dict."""
    return run_groth16(log_constraints, seed, repeats, device,
                       progress).record()


@dataclass
class PinocchioRun:
    """What `run_pinocchio` did: the instance, the keypair, the last proof
    and each stage's time.  `keygen_launches` counts each kernel's
    launches during keygen alone."""
    log_constraints: int
    zk: bool
    inst: SyntheticR1CS
    pkey: object
    vkey: object
    witness: torch.Tensor
    public: dict
    proof: object
    build_r1cs_s: float
    keygen_s: float
    keygen_launches: dict
    prove_first_s: float
    warm_s: List[float]
    verify_s: float
    verified: bool

    def record(self) -> dict:
        """The dict of the JAX package's `bench_pinocchio`."""
        n = 1 << self.log_constraints
        prove_s = min(self.warm_s)
        # G1-equivalent terms: 5 G1 mid MSMs + h (n) + 2 G2 mid (~3x) + ZK 2
        # all-variable MSMs (the JAX package's count)
        msm_terms = 5 * n + n + 3 * 2 * n + (2 * n if self.zk else 0)
        return {
            "log_constraints": self.log_constraints,
            "domain_log": self.inst.fc.logn,
            "keygen_s": self.keygen_s,
            "prove_first_s": self.prove_first_s,
            "prove_s": prove_s,
            "verify_s": self.verify_s,
            "msm_terms_per_prove": msm_terms,
            "msm_mops_per_s": msm_terms / prove_s / 1e6,
            "verified": self.verified,
            "zk": self.zk,
        }


def run_pinocchio(log_constraints: int, seed: int = 1, repeats: int = 3,
                  zk: bool = True, device=None,
                  progress: dict = None) -> PinocchioRun:
    """Pinocchio on the synthetic R1CS, as the JAX package's
    `bench_pinocchio` runs it: keygen, one cold and `repeats` warm proves
    (8 G1 + 2 G2 MSMs with ZK), verify.  Runs on `device` (default: the
    card); raises if the proof does not verify."""
    from .golden.field import Fr
    from .engine.torch_engine import checked_device
    from .protocols import pinocchio_device as pd
    from .rng import Gen

    device = checked_device(device)
    st = _Stages(device, progress)
    inst = _build(log_constraints, seed, st)
    fc = inst.fc
    (pk, vk), keygen_s = st.run(lambda: pd.keygen_device(
        fc, mids=list(inst.mids_cols), ios=list(inst.ios_cols),
        rng=Gen(b"bench-pin-keygen"), device=device))
    keygen_launches = st.launches
    st.done("keygen_s", keygen_s)

    wm = inst.pack_witness(device)
    t0 = time.time()
    proof = pd.prove_device(pk, fc, wm, Gen(b"bench-pin-prove"), zk=zk)
    prove_first_s = time.time() - t0
    st.done("prove_first_s", prove_first_s)
    times = []
    for i in range(repeats):
        t0 = time.time()
        proof = pd.prove_device(pk, fc, wm, Gen(b"bench-pin-%d" % i), zk=zk)
        times.append(time.time() - t0)
    st.done("prove_s", min(times), 4)

    t0 = time.time()
    public = {int(c): Fr(inst.witness[c]) for c in inst.ios_cols}
    ok = pd.verify(public, vk, proof)
    verify_s = time.time() - t0
    st.done("verify_s", verify_s)
    if not ok:
        raise AssertionError("benchmark proof failed to verify")
    return PinocchioRun(
        log_constraints=log_constraints, zk=zk, inst=inst, pkey=pk, vkey=vk,
        witness=wm, public=public, proof=proof,
        build_r1cs_s=st.progress["build_r1cs_s"], keygen_s=keygen_s,
        keygen_launches=keygen_launches, prove_first_s=prove_first_s,
        warm_s=times, verify_s=verify_s, verified=ok)


def bench_pinocchio(log_constraints: int, seed: int = 1, repeats: int = 3,
                    zk: bool = True, device=None,
                    progress: dict = None) -> dict:
    """`run_pinocchio`, returning the JAX package's `bench_pinocchio`
    dict."""
    return run_pinocchio(log_constraints, seed, repeats, zk, device,
                         progress).record()
