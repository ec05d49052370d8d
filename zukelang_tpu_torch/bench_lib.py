"""Synthetic R1CS instances and the Pinocchio bench run.

Counterpart of `zukelang_tpu.bench_lib.make_synthetic_r1cs`,
`canon_pad_log` and `bench_pinocchio`.  The same seed gives the same
instance: the same gate indices, witness values and mids/ios partition.
The bench record itself (`bench_groth16`, `bench_rung`) is later work.

Instance shape: a multiplicative chain.  w_0 = 1 (ONE), w_1 = x secret;
gate g asserts w_{g+2} = w_{a_g} * w_{b_g} with a_g, b_g < g+2 drawn
at random.  One public output (the last wire).  `pad_log` pads the domain
with 0 = 0*0 gates and zero-valued dummy mid variables.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List

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
                  zk: bool = True, device=None) -> PinocchioRun:
    """Pinocchio on the synthetic R1CS, as the JAX package's
    `bench_pinocchio` runs it: keygen, one cold and `repeats` warm proves
    (8 G1 + 2 G2 MSMs with ZK), verify.  Runs on `device` (default: the
    card); raises if the proof does not verify."""
    from .golden.field import Fr
    from .ops import kernels as K
    from .protocols import groth16_device as gd
    from .protocols import pinocchio_device as pd
    from .rng import Gen

    device = gd._device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    inst = make_synthetic_r1cs(log_constraints, seed,
                               pad_log=canon_pad_log(log_constraints))
    fc = inst.fc
    build_r1cs_s = time.time() - t0

    before = dict(K.LAUNCHES)
    t0 = time.time()
    pk, vk = pd.keygen_device(fc, mids=list(inst.mids_cols),
                              ios=list(inst.ios_cols),
                              rng=Gen(b"bench-pin-keygen"), device=device)
    sync()
    keygen_s = time.time() - t0
    keygen_launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}

    wm = inst.pack_witness(device)
    t0 = time.time()
    proof = pd.prove_device(pk, fc, wm, Gen(b"bench-pin-prove"), zk=zk)
    prove_first_s = time.time() - t0
    times = []
    for i in range(repeats):
        t0 = time.time()
        proof = pd.prove_device(pk, fc, wm, Gen(b"bench-pin-%d" % i), zk=zk)
        times.append(time.time() - t0)

    t0 = time.time()
    public = {int(c): Fr(inst.witness[c]) for c in inst.ios_cols}
    ok = pd.verify(public, vk, proof)
    verify_s = time.time() - t0
    if not ok:
        raise AssertionError("benchmark proof failed to verify")
    return PinocchioRun(
        log_constraints=log_constraints, zk=zk, inst=inst, pkey=pk, vkey=vk,
        witness=wm, public=public, proof=proof, build_r1cs_s=build_r1cs_s,
        keygen_s=keygen_s, keygen_launches=keygen_launches,
        prove_first_s=prove_first_s, warm_s=times, verify_s=verify_s,
        verified=ok)


def bench_pinocchio(log_constraints: int, seed: int = 1, repeats: int = 3,
                    zk: bool = True, device=None) -> dict:
    """`run_pinocchio`, returning the JAX package's `bench_pinocchio`
    dict."""
    return run_pinocchio(log_constraints, seed, repeats, zk, device).record()
