"""Rank targets of the sharded tests (`tests/test_torch_sharded.py`).

`run(mesh, cases)` runs each case on this rank and returns its outputs as
numpy arrays, keyed "<case key>.<output>": the spawned ranks import only
this package, and the test process compares what comes back with the JAX
package.  A case is (key, name, kwargs), its inputs numpy arrays (port
limb layout) or plain values:
  gate_eval   idx, coef, w          -> block (this rank's gates)
  ntt         x, log1, log2         -> block
  intt        x, log1, log2         -> block
  phase_times x, log1, log2         -> the five keys of
                                       `sharded_ntt_phase_times`
  reduction   logn, seed            -> a, b, h of the sharded reduction
  msm         points, scalars, group, c, max_windows -> point (compressed)
  msm_whole   points, scalars, group, c -> point of `msm_g1` / `msm_g2`,
                                       on the last rank only
  msm_window  points, digits, c, group -> point
  fixed_base  scalars, group, c     -> block (X, Y, Z stacked)
  prove_step  logn, seed, s, max_windows -> point: `sharded_prove_step`
                                       over the l side and {g s^i}
  groth16     logn, seed            -> proof, reference, verified
  pinocchio   logn, seed, zks       -> tail, then for each zk of zks
                                       (zk / nonzk).proof, reference,
                                       verified
The proves run the dry run's steps (`parallel.dryrun`): keygen on the
rank, the sharded prove, and on rank 0 `prove_device` under the same rng
and verify.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bench_lib
from ..engine import torch_engine as te
from ..ops import msm as msm_mod
from ..parallel import dryrun, sharded
from ..protocols.pinocchio import PROOF_FIELDS


def _t(mesh, a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)


def _gate_eval(mesh, offsets, cols, coef, w):
    return {"block": sharded.sharded_gate_eval(
        mesh, (_t(mesh, offsets), _t(mesh, cols), _t(mesh, coef)),
        _t(mesh, w))}


def _ntt(mesh, x, log1, log2, inverse=False):
    return {"block": sharded.sharded_ntt(mesh, _t(mesh, x), log1, log2,
                                         inverse)}


def _intt(mesh, x, log1, log2):
    return {"block": sharded.sharded_intt(mesh, _t(mesh, x), log1, log2)}


def _phase_times(mesh, x, log1, log2):
    return sharded.sharded_ntt_phase_times(mesh, _t(mesh, x), log1, log2,
                                           repeats=1)


def _reduction(mesh, logn, seed):
    inst = bench_lib.make_synthetic_r1cs(logn, seed=seed)
    a, b, h = sharded.sharded_witness_reduction(
        mesh, inst.fc, inst.pack_witness(mesh.device))
    return {"a": a, "b": b, "h": h}


def _point(pt) -> dict:
    return {"point": np.frombuffer(pt.to_compressed_bytes(), dtype=np.uint8)}


def _msm(mesh, points, scalars, group, c, max_windows=None):
    return _point(sharded.sharded_msm(mesh, tuple(_t(mesh, p) for p in points),
                                      _t(mesh, scalars), group, c,
                                      max_windows))


def _msm_whole(mesh, points, scalars, group, c):
    if mesh.rank != mesh.size - 1:
        return {}
    fn = msm_mod.msm_g1 if group == "g1" else msm_mod.msm_g2
    pt = fn(tuple(_t(mesh, p) for p in points), _t(mesh, scalars), c)
    return _point(sharded._unpack(group)(pt)[0])


def _msm_window(mesh, points, digits, c, group):
    pt = sharded.sharded_msm_window(mesh, tuple(_t(mesh, p) for p in points),
                                    _t(mesh, digits), c, group)
    return _point(sharded._unpack(group)(pt)[0])


def _fixed_base(mesh, scalars, group, c):
    return {"block": torch.stack(sharded.sharded_fixed_base(
        mesh, _t(mesh, scalars), group, c))}


def _prove_step(mesh, logn, seed, s, max_windows):
    inst = bench_lib.make_synthetic_r1cs(logn, seed=seed)
    ti1 = msm_mod.g_powers(s, (1 << logn) - 1, "g1", mesh.device, c=4)
    return _point(sharded.sharded_prove_step(
        mesh, te.side_tensors(inst.fc.l, mesh.device),
        inst.pack_witness(mesh.device), ti1, logn, max_windows))


def _groth16(mesh, logn, seed):
    with dryrun.small_windows():
        it = dryrun.Instance(mesh, logn, seed)
        crs, vkey = dryrun.groth16_keys(mesh, it)
        proof = dryrun.groth16_sharded(mesh, it, crs)
        out = {"proof": dryrun.proof_bytes(proof, dryrun.G16_FIELDS)}
        if mesh.rank == 0:
            out.update(dryrun.groth16_reference(it, crs, vkey, proof))
    return out


def _pinocchio(mesh, logn, seed, zks):
    """One keygen, then a sharded prove for each of `zks` (outputs
    "zk.*" / "nonzk.*"), the references on rank 0."""
    out = {}
    with dryrun.small_windows():
        it = dryrun.Instance(mesh, logn, seed)
        pkey, vkey = dryrun.pinocchio_keys(mesh, it)
        out["tail"] = np.array(len(pkey.v_all_tail))
        proofs = {zk: dryrun.pinocchio_sharded(mesh, it, pkey, zk)
                  for zk in zks}
        for zk, proof in proofs.items():
            tag = "zk" if zk else "nonzk"
            out[f"{tag}.proof"] = dryrun.proof_bytes(proof, PROOF_FIELDS)
            if mesh.rank == 0:
                ref = dryrun.pinocchio_reference(it, pkey, vkey, proof, zk)
                out.update({f"{tag}.{k}": v for k, v in ref.items()})
    return out


CASES = {"gate_eval": _gate_eval, "ntt": _ntt, "intt": _intt,
         "phase_times": _phase_times, "reduction": _reduction, "msm": _msm,
         "msm_whole": _msm_whole, "msm_window": _msm_window, "fixed_base": _fixed_base,
         "prove_step": _prove_step, "groth16": _groth16,
         "pinocchio": _pinocchio}


def run(mesh, cases) -> dict:
    out = {}
    for key, name, kwargs in cases:
        for k, v in CASES[name](mesh, **kwargs).items():
            out[f"{key}.{k}"] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                 else np.asarray(v))
    return out
