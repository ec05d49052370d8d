"""The multi-rank dry run: the sharded proves and the c = 8 MSM against the
single-device ones, on a world of ranks.

Counterpart of `dryrun_multichip` in the JAX package's `__graft_entry__.py`
(:153-273).  Three stages, each run on every rank of a world:
  1. the sharded Groth16 prove (`sharded.sharded_groth16_prove`, c = 4)
     on `make_synthetic_r1cs(logn, seed=3)`, equal to
     `groth16_device.prove_device`'s proof under the same injected rng,
     and verified;
  2. the sharded Pinocchio ZK prove, likewise against
     `pinocchio_device.prove_device`;
  3. the c = 8 term-sharded G1 MSM at 2^msm_log over fixed-base points,
     equal to golden `G1.dot`.
Every stage runs or the run fails: none is skipped for a time budget.  The
MSM and fixed-base windows of the device protocols are pinned to 4 during
the run, as the JAX dry run pins them.  The references run after the
sharded stages, stage i's on rank i mod D, so that the ranks share them.

    python -m zukelang_tpu_torch.parallel.dryrun [--ranks N] [--device cpu]
        [--logn L]

runs `dryrun_multichip`: a world of N ranks (default 1) on the card, each
rank on its own (NCCL), or with `--device cpu` on gloo.  Without CUDA it
refuses to run unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import bench_lib, params
from ..golden.curve import G1
from ..golden.field import Fr
from ..ops import field as F
from ..ops import msm as msm_mod
from ..params import FR
from ..protocols import groth16_device as gd
from ..protocols import pinocchio_device as pd
from ..protocols.pinocchio import PROOF_FIELDS
from ..rng import Gen
from . import launch, sharded

SEED = 3
STAGES = ("groth16", "pinocchio_zk", "msm_c8")
G16_FIELDS = ("a", "b", "c")


@contextlib.contextmanager
def small_windows():
    """The device protocols' MSM and fixed-base windows pinned to 4."""
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW = gd.DEFAULT_FB_WINDOW = 4
    try:
        yield
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved


def default_logn(n_ranks: int) -> int:
    """The smallest domain the JAX dry run takes: both four-step factors
    divisible by the number of ranks."""
    return max(6, 2 * max(1, (n_ranks - 1).bit_length()))


def proof_bytes(proof, fields) -> np.ndarray:
    return np.frombuffer(b"".join(getattr(proof, f).to_compressed_bytes()
                                  for f in fields), dtype=np.uint8)


class Instance:
    """The synthetic circuit of a stage, its witness on the mesh's device
    and its public inputs."""

    def __init__(self, mesh, logn: int, seed: int = SEED):
        inst = bench_lib.make_synthetic_r1cs(logn, seed=seed)
        self.fc = inst.fc
        self.wm = inst.pack_witness(mesh.device)
        self.public = {int(c): Fr(inst.witness[c]) for c in inst.ios_cols}
        self.mids = list(inst.mids_cols)
        self.ios = list(inst.ios_cols)


def groth16_keys(mesh, it: Instance):
    return gd.keygen_device(it.fc, it.mids, it.ios, Gen(b"dryrun-keygen"),
                            mesh.device)


def pinocchio_keys(mesh, it: Instance):
    return pd.keygen_device(it.fc, it.mids, it.ios, Gen(b"dryrun-pin-keygen"),
                            mesh.device)


def groth16_sharded(mesh, it: Instance, crs):
    return sharded.sharded_groth16_prove(mesh, crs, it.fc, it.wm,
                                         Gen(b"dryrun-prove"), c=4)


def groth16_reference(it: Instance, crs, vkey, proof) -> dict:
    """prove_device's proof under the same rng, and whether the sharded
    proof verifies."""
    ref = gd.prove_device(crs, it.fc, it.wm, Gen(b"dryrun-prove"))
    return {"reference": proof_bytes(ref, G16_FIELDS),
            "verified": np.array(gd.verify(it.public, vkey, proof))}


def pinocchio_sharded(mesh, it: Instance, pkey, zk: bool):
    return sharded.sharded_pinocchio_prove(mesh, pkey, it.fc, it.wm,
                                           Gen(b"dryrun-pin-prove"), zk=zk,
                                           c=4)


def pinocchio_reference(it: Instance, pkey, vkey, proof, zk: bool) -> dict:
    ref = pd.prove_device(pkey, it.fc, it.wm, Gen(b"dryrun-pin-prove"), zk=zk)
    return {"reference": proof_bytes(ref, PROOF_FIELDS),
            "verified": np.array(pd.verify(it.public, vkey, proof))}


def msm_inputs(msm_log: int):
    """The JAX dry run's stage 3 inputs: 2^msm_log scalars and base
    multipliers from numpy's RandomState(17)."""
    n = 1 << msm_log
    rng = np.random.RandomState(17)
    sc = [int.from_bytes(rng.bytes(32), "little") % params.R
          for _ in range(n)]
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    return sc, ks


def msm_sharded(mesh, msm_log: int, c: int = 8):
    """Stage 3's term-sharded G1 MSM (bases from a c = 4 fixed-base
    batch, as in the JAX dry run) -> golden point."""
    sc, ks = msm_inputs(msm_log)
    pts = msm_mod.fixed_base_mul(F.pack(ks, FR, mesh.device), group="g1",
                                 c=4)
    return sharded.sharded_msm(mesh, pts, F.pack(sc, FR, mesh.device), "g1",
                               c=c)


def msm_golden(msm_log: int):
    sc, ks = msm_inputs(msm_log)
    g = G1.generator()
    return G1.dot([g * k for k in ks], [Fr(s) for s in sc])


def run_stages(mesh, logn: int, msm_log: int) -> dict:
    """Rank target of the dry run: the three sharded stages, then the
    references stage i on rank i mod D -> {stage.key: array}."""
    out = {}
    with small_windows():
        it = Instance(mesh, logn)
        crs, gvk = groth16_keys(mesh, it)
        pkey, pvk = pinocchio_keys(mesh, it)
        g16 = groth16_sharded(mesh, it, crs)
        pin = pinocchio_sharded(mesh, it, pkey, True)
        out["groth16.proof"] = proof_bytes(g16, G16_FIELDS)
        out["pinocchio_zk.proof"] = proof_bytes(pin, PROOF_FIELDS)
        pt = msm_sharded(mesh, msm_log)
        out["msm_c8.point"] = np.frombuffer(pt.to_compressed_bytes(),
                                            dtype=np.uint8)
        mine = [s for i, s in enumerate(STAGES) if i % mesh.size == mesh.rank]
        if "groth16" in mine:
            ref = groth16_reference(it, crs, gvk, g16)
            out.update({f"groth16.{k}": v for k, v in ref.items()})
        if "pinocchio_zk" in mine:
            ref = pinocchio_reference(it, pkey, pvk, pin, True)
            out.update({f"pinocchio_zk.{k}": v for k, v in ref.items()})
        if "msm_c8" in mine:
            out["msm_c8.reference"] = np.frombuffer(
                msm_golden(msm_log).to_compressed_bytes(), dtype=np.uint8)
    return out


def dryrun_multichip(n_ranks: int, device=None, logn: int = None,
                     msm_log: int = 10, log=print) -> dict:
    """The three stages on a new world of n_ranks ranks (`launch.spawn`).
    Raises where a sharded result differs from its reference on any rank
    or a proof does not verify; -> {stage: {"proof" or "point",
    "reference", "verified"}} as numpy arrays (rank 0's results, the
    references from the rank that ran them)."""
    t0 = time.time()
    logn = default_logn(n_ranks) if logn is None else logn
    ranks = launch.spawn("zukelang_tpu_torch.parallel.dryrun.run_stages",
                         n_ranks, device, logn, msm_log)
    res = {}
    for stage in STAGES:
        got = "point" if stage == "msm_c8" else "proof"
        res[stage] = {got: ranks[0][f"{stage}.{got}"]}
        for r in ranks:
            if not np.array_equal(r[f"{stage}.{got}"], res[stage][got]):
                raise AssertionError(f"dryrun: {stage} differs across ranks")
            for k in ("reference", "verified"):
                if f"{stage}.{k}" in r:
                    res[stage][k] = r[f"{stage}.{k}"]
        if not np.array_equal(res[stage][got], res[stage]["reference"]):
            raise AssertionError(f"dryrun: the sharded {stage} differs from "
                                 "its single-device reference")
        if not bool(res[stage].get("verified", True)):
            raise AssertionError(f"dryrun: the sharded {stage} proof does "
                                 "not verify")
    what = {"groth16": f"sharded Groth16 prove at 2^{logn} == prove_device; "
                       "verified",
            "pinocchio_zk": f"sharded Pinocchio ZK prove at 2^{logn} == "
                            "prove_device; verified",
            "msm_c8": f"sharded c=8 G1 MSM at 2^{msm_log} == golden G1.dot"}
    for stage in STAGES:
        log(f"dryrun_multichip: {what[stage]} on {n_ranks} ranks "
            f"({launch._backend(device)}) [{time.time() - t0:.0f}s]")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the CPU (default: the card)")
    ap.add_argument("--logn", type=int, default=None)
    args = ap.parse_args(argv)
    if torch.device(args.device or "cuda").type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("dryrun: needs a CUDA device (pass --device cpu for "
                         "gloo on the CPU)")
    dryrun_multichip(args.ranks, args.device, args.logn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
