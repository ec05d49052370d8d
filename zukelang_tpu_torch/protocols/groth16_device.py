"""Device-resident Groth16 on PyTorch tensors.

Counterpart of `zukelang_tpu/protocols/groth16_device.py`: the CRS and the
prover state live on the device as limb tensors; only the three proof
points and the small verifying key come back to the host.  The scalars are
drawn in the reference's order (alpha, beta, gamma, delta, tau; then r,
s), so under the same injected rng the proof is byte-equal to the JAX
package's and to its golden `Groth16` (`zukelang_tpu/protocols/groth16.py`).

Keygen: the transpose matvec at Lagrange(tau), then fixed-base batches
(`ops.msm.fixed_base_mul`: K5 tails-only from 128 elements, K3 mixed adds
below) and `to_affine`, through the steps of `protocols.device`.  Prove:
`device.prove` runs the witness reduction (NTT pipeline) and the MSMs
that `msms` states, one batch of four G1 MSMs and one G2 MSM, then the
proof is assembled from their sums in the port's host library
(`assemble_proof`: one call of `native.groth16_assemble`).  Verify: host
pairings (`pairing`, the same library).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native, params, util
from .. import serialize as ser
from ..core import flat as flat_mod
from ..engine import torch_engine as te
from ..golden.curve import G1, G2, GT
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..pairing import pairing
from ..params import FR
from . import device as steps
from .groth16 import Proof


@dataclass
class DeviceCRS:
    """Proving key on the device (groth16.ml:24-34 layout, packed)."""
    alpha_g1: G1               # host single points
    beta_g1: G1
    beta_g2: G2
    delta_g1: G1
    delta_g2: G2
    ti1: C.AffinePoint         # {tau^i} G1, affine (X, Y), padded width
    ti2: C.AffinePoint         # {tau^i} G2
    ltd_mid: C.AffinePoint     # {L_k(tau)/delta} for mids
    tiztd: C.AffinePoint       # {tau^i Z(tau)/delta}
    mids_idx: np.ndarray       # witness columns feeding ltd_mid
    n: int                     # domain size (degree of Z)


@dataclass
class DeviceVKey:
    one1: G1
    ltgm_io: Dict              # var -> G1
    one2: G2
    gm: G2
    d: G2
    ab: GT
    alpha_g1: Optional[G1] = None
    beta_g2: Optional[G2] = None


# MSM window width; None = size-based auto (ops.msm.auto_window).
DEFAULT_MSM_WINDOW = None
# Fixed-base window width of the keygen tables (2^c entries per window).
DEFAULT_FB_WINDOW = 16

_CRS_POINTS = ("ti1", "ti2", "ltd_mid", "tiztd")


def keygen_device(fc: flat_mod.FlatCircuit, mids: Sequence, ios: Sequence,
                  rng, device=None) -> Tuple[DeviceCRS, DeviceVKey]:
    """Groth16 setup on `device` (default: the card).  mids/ios are the
    circuit partition; the trapdoor is drawn as alpha, beta, gamma,
    delta, tau.  Runs under a span `zk.keygen` with a new keygen id."""
    device = te.checked_device(device)
    with util.stage("zk.keygen", request=util.next_request(),
                    n=fc.domain_size):
        return _keygen(fc, mids, ios, rng, device)


def _keygen(fc: flat_mod.FlatCircuit, mids: Sequence, ios: Sequence, rng,
            device) -> Tuple[DeviceCRS, DeviceVKey]:
    alpha, beta, gamma, delta, tau = (rng.fr() for _ in range(5))
    n = fc.domain_size
    r = params.R
    c = DEFAULT_FB_WINDOW

    # per-variable evaluations at tau (transpose matvec)
    v_at, w_at, y_at = steps.eval_at(fc, tau.n, device)
    nv = len(fc.vars_sorted)
    # L_k(tau) = beta*v_k + alpha*w_k + y_k, then /delta (mids), /gamma (ios)
    l_at = F.add(F.add(
        F.mont_mul(v_at, F.const_mont(beta.n, nv, FR, device), FR),
        F.mont_mul(w_at, F.const_mont(alpha.n, nv, FR, device), FR),
        FR), y_at, FR)
    mids_idx = np.array([fc.var_index[v] for v in sorted(mids)], dtype=np.int64)
    ios_idx = np.array([fc.var_index[v] for v in sorted(ios)], dtype=np.int64)
    dinv = pow(delta.n, -1, r)
    ginv = pow(gamma.n, -1, r)

    def scaled(idx, k):
        cols = l_at[:, torch.from_numpy(idx).to(l_at.device)]
        return F.mont_mul(cols, F.const_mont(k, len(idx), FR, device), FR)

    # the powers of tau and the Z(tau) ladder (n entries; tau^n enters the
    # proof only through Z(tau) inside tiztd)
    ti = steps.powers(tau.n, n)
    ztd = (pow(tau.n, n, r) - 1) * dinv % r
    tizd = [t * ztd % r for t in ti[:n - 1]]

    # the three G1 tables share one batched inversion in to_affine; their
    # Jacobian forms go before the G2 table comes
    ti1, tiztd, ltd_mid = steps.to_affine("g1", steps.fixed_base(
        "g1", "crs", [ti, tizd, scaled(mids_idx, dinv)], c, device))
    (ti2,) = steps.to_affine("g2", steps.fixed_base("g2", "crs", [ti], c,
                                                    device))
    (io_part,) = steps.fixed_base("g1", "vkey", [scaled(ios_idx, ginv)], c,
                                  device)
    ltgm_io_pts = C.unpack_g1(io_part)

    with util.stage("zk.keygen.host_points", host=True):
        g1, g2 = G1.generator(), G2.generator()
        crs = DeviceCRS(
            alpha_g1=g1 * alpha, beta_g1=g1 * beta, beta_g2=g2 * beta,
            delta_g1=g1 * delta, delta_g2=g2 * delta,
            ti1=ti1, ti2=ti2, ltd_mid=ltd_mid, tiztd=tiztd,
            mids_idx=mids_idx.astype(np.int32), n=n)
        vkey = DeviceVKey(
            one1=g1,
            ltgm_io={v: ltgm_io_pts[i] for i, v in enumerate(sorted(ios))},
            one2=g2, gm=g2 * gamma, d=g2 * delta,
            ab=pairing(g1 * alpha, g2 * beta), alpha_g1=g1 * alpha,
            beta_g2=g2 * beta)
    return crs, vkey


def prove_device(crs: DeviceCRS, fc: flat_mod.FlatCircuit,
                 witness_mont: torch.Tensor, rng):
    """Groth16 prove (groth16.ml:123-161).  witness_mont: (8, V+1)
    Montgomery witness (flat.pack_witness layout), moved to the CRS's
    device.  Runs under a span `zk.prove` with a new proof id."""
    with util.stage("zk.prove", request=util.next_request()):
        r_sc = rng.fr()
        s_sc = rng.fr()
        g1, g2 = steps.prove(crs.ti1[0].device, fc, witness_mont,
                             functools.partial(msms, crs), DEFAULT_MSM_WINDOW)
        return assemble_proof(crs, *g1, *g2, r_sc, s_sc)


def msms(crs: DeviceCRS, w: torch.Tensor, reduction) -> tuple:
    """The prove's MSMs at the domain's padded width (the statement
    `device.prove` and the sharded prover run): G1 A = <a, ti1>,
    B1 = <b, ti1>, H = <h, tiztd>, Cmid = <w_mids, ltd_mid>; G2
    B = <b, ti2>, with (a, b, h) the witness reduction's."""
    a, b, h = reduction
    mids = torch.from_numpy(crs.mids_idx.astype(np.int64)).to(w.device)
    return (msm_mod.padded_width(crs.n),
            [(crs.ti1, a), (crs.ti1, b),
             (crs.tiztd, h[:, :max(1, crs.n - 1)]), (crs.ltd_mid, w[:, mids])],
            [(crs.ti2, b)])


def assemble_proof(crs: DeviceCRS, A: G1, B1: G1, H: G1, Cmid: G1, B: G2,
                   r, s) -> Proof:
    """The proof from the MSM sums (host points) and the prover's r, s
    (groth16.ml:123-161): a = alpha + A + delta r, b = beta_2 + B +
    delta_2 s, c = Cmid + H + a s + (beta + B1 + delta s) r - delta r s,
    in one call of the host library, under a span `zk.prove.assemble`."""
    with util.stage("zk.prove.assemble", host=True):
        a, b, c = native.groth16_assemble(
            crs.alpha_g1, crs.beta_g1, crs.delta_g1, crs.beta_g2,
            crs.delta_g2, A, B1, H, Cmid, B, r, s)
        return Proof(a=a, b=b, c=c)


def verify(public: Dict, vkey: DeviceVKey, proof) -> bool:
    io_sorted = sorted(vkey.ltgm_io.keys())
    if set(public.keys()) != set(io_sorted):
        return False
    lio = G1.dot([vkey.ltgm_io[k] for k in io_sorted],
                 [public[k] for k in io_sorted])
    return (pairing(proof.a, proof.b)
            == vkey.ab + pairing(lio, vkey.gm) + pairing(proof.c, vkey.d))


# ---------------------------------------------------------------------------
# Keypair files: the JAX package's save_keypair .npz format (16-bit limbs)
# ---------------------------------------------------------------------------

def crs_from_jax(jcrs, device=None) -> DeviceCRS:
    """A JAX-package DeviceCRS (its arrays read as numpy, its host points
    through their bytes) -> this port's, on `device` (default: the card)."""
    device = te.checked_device(device)
    pts = {name: C.from_jax(tuple(np.asarray(x) for x in getattr(jcrs, name)),
                            device) for name in _CRS_POINTS}
    return DeviceCRS(
        **{k: steps.host_point(getattr(jcrs, k)) for k in
           ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")},
        mids_idx=np.asarray(jcrs.mids_idx), n=int(jcrs.n), **pts)


def _crs_arrays(crs: DeviceCRS) -> dict:
    arrays = {}
    for name in _CRS_POINTS:
        for coord, arr in zip("xy", C.to_jax(getattr(crs, name))):
            arrays[f"{name}_{coord}"] = arr
    arrays["mids_idx"] = np.asarray(crs.mids_idx, dtype=np.int32)
    arrays["n"] = np.array([crs.n])
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        arrays[name] = np.frombuffer(
            getattr(crs, name).to_compressed_bytes(), dtype=np.uint8)
    return arrays


def save_keypair(path: str, crs: DeviceCRS, vkey: DeviceVKey) -> None:
    """CRS + verification key in one .npz, readable by both packages."""
    vk = {
        "one1": ser.g1_to_json(vkey.one1), "one2": ser.g2_to_json(vkey.one2),
        "gm": ser.g2_to_json(vkey.gm), "d": ser.g2_to_json(vkey.d),
        "ab": ser.gt_to_json(vkey.ab),
        "ltgm_io": {str(k): ser.g1_to_json(v) for k, v in vkey.ltgm_io.items()},
    }
    if vkey.alpha_g1 is not None:
        vk["alpha_g1"] = ser.g1_to_json(vkey.alpha_g1)
    if vkey.beta_g2 is not None:
        vk["beta_g2"] = ser.g2_to_json(vkey.beta_g2)
    arrays = _crs_arrays(crs)
    arrays["vkey_json"] = np.frombuffer(json.dumps(vk).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_crs(path: str, fc: flat_mod.FlatCircuit, device=None) -> DeviceCRS:
    """Read a keypair file's proving key onto `device` (default: the
    card), checked against the circuit: its domain size and witness
    columns must match `fc`."""
    device = te.checked_device(device)
    with np.load(path) as z:
        n = int(z["n"][0])
        if n != fc.domain_size:
            raise ValueError(f"keypair domain {n} != circuit domain "
                             f"{fc.domain_size}")
        mids_idx = np.asarray(z["mids_idx"])
        if mids_idx.size and (mids_idx.min() < 0
                              or mids_idx.max() >= len(fc.vars_sorted)):
            raise ValueError("keypair mids_idx out of the circuit's range")

        def pt(name):
            if f"{name}_z" in z.files:     # pre-affine checkpoint
                return C.to_affine(C.from_jax(
                    tuple(z[f"{name}_{c}"] for c in "xyz"), device))
            return C.from_jax(tuple(z[f"{name}_{c}"] for c in "xy"), device)

        return DeviceCRS(
            alpha_g1=G1.of_compressed_bytes(z["alpha_g1"].tobytes()),
            beta_g1=G1.of_compressed_bytes(z["beta_g1"].tobytes()),
            beta_g2=G2.of_compressed_bytes(z["beta_g2"].tobytes()),
            delta_g1=G1.of_compressed_bytes(z["delta_g1"].tobytes()),
            delta_g2=G2.of_compressed_bytes(z["delta_g2"].tobytes()),
            mids_idx=mids_idx, n=n,
            **{name: pt(name) for name in _CRS_POINTS})


def load_keypair(path: str, fc: flat_mod.FlatCircuit, device=None):
    """Inverse of save_keypair (and of the JAX package's): (DeviceCRS,
    DeviceVKey), with the CRS checked against the circuit `fc`."""
    crs = load_crs(path, fc, device)
    with np.load(path) as z:
        vk = json.loads(bytes(z["vkey_json"].tobytes()).decode())
    vkey = DeviceVKey(
        one1=ser.g1_of_json(vk["one1"]),
        ltgm_io={int(k): ser.g1_of_json(v) for k, v in vk["ltgm_io"].items()},
        one2=ser.g2_of_json(vk["one2"]), gm=ser.g2_of_json(vk["gm"]),
        d=ser.g2_of_json(vk["d"]), ab=ser.gt_of_json(vk["ab"]),
        alpha_g1=ser.g1_of_json(vk["alpha_g1"]) if "alpha_g1" in vk else None,
        beta_g2=ser.g2_of_json(vk["beta_g2"]) if "beta_g2" in vk else None)
    return crs, vkey
