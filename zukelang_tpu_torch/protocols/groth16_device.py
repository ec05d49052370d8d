"""Device-resident Groth16 on PyTorch tensors.

Counterpart of `zukelang_tpu/protocols/groth16_device.py`: the CRS and the
prover state live on the device as limb tensors; only the three proof
points and the small verifying key come back to the host.  The scalars are
drawn in the reference's order (alpha, beta, gamma, delta, tau; then r,
s), so under the same injected rng the proof is byte-equal to the JAX
package's and to its golden `Groth16` (`zukelang_tpu/protocols/groth16.py`).

Keygen: the transpose matvec at Lagrange(tau), then fixed-base batches
(`ops.msm.fixed_base_mul`: K5 tails-only from 128 elements, K3 mixed adds
below) and `to_affine`.  Prove: the witness reduction (NTT pipeline), one
batch of four G1 MSMs and one G2 MSM.  Verify: host pairings (`pairing`,
the port's native library).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import params
from .. import serialize as ser
from ..core import flat as flat_mod
from ..engine import torch_engine as te
from ..golden.curve import G1, G2, GT
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..pairing import pairing
from ..params import FR
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


def _pad_scalars(s: torch.Tensor, n: int) -> torch.Tensor:
    cur = s.shape[1]
    return torch.nn.functional.pad(s, (0, n - cur)) if cur < n else s[:, :n]


def _fit_points(p: C.AffinePoint, n: int) -> C.AffinePoint:
    """Truncate or pad (with the (0, 0) infinity marker) to width n."""
    cur = p[0].shape[-1]
    if cur >= n:
        return tuple(x[..., :n].contiguous() for x in p)
    return tuple(torch.nn.functional.pad(x, (0, n - cur)) for x in p)


def _msm_device_deferred(points: C.AffinePoint, scalars_mont: torch.Tensor,
                         group: str, c: int = None):
    """One MSM sized by its scalar count; returns resolve() -> point."""
    n = msm_mod.padded_width(scalars_mont.shape[1])
    S = F.from_mont(_pad_scalars(scalars_mont, n), FR)
    return msm_mod.msm_staged_deferred(_fit_points(points, n), S,
                                       group=group, c=c)


def _fixed_base_std(scalars, group: str, device) -> C.Point:
    n = msm_mod.padded_width(len(scalars), msm_mod.FB_MIN_LOG)
    S = F.pack(list(scalars) + [0] * (n - len(scalars)), FR, device)
    return msm_mod.fixed_base_mul(S, group=group, c=DEFAULT_FB_WINDOW)


def _fixed_base_mont(scalars_mont: torch.Tensor, group: str) -> C.Point:
    n = msm_mod.padded_width(scalars_mont.shape[1],
                             msm_mod.FB_MIN_LOG)
    S = F.from_mont(_pad_scalars(scalars_mont, n), FR)
    return msm_mod.fixed_base_mul(S, group=group, c=DEFAULT_FB_WINDOW)


def _affine_many(parts: Sequence[C.Point]) -> list:
    """Jacobian batches of one group -> their affine batches, with one
    batched inversion (`to_affine`) over all of them."""
    widths = [p[0].shape[-1] for p in parts]
    aff = C.to_affine(tuple(torch.cat([p[i] for p in parts], dim=-1)
                            for i in range(3)))
    offs = np.cumsum([0] + widths)
    return [tuple(x[..., offs[k]:offs[k + 1]].contiguous() for x in aff)
            for k in range(len(parts))]


def keygen_device(fc: flat_mod.FlatCircuit, mids: Sequence, ios: Sequence,
                  rng, device=None) -> Tuple[DeviceCRS, DeviceVKey]:
    """Groth16 setup on `device` (default: the card).  mids/ios are the
    circuit partition; the trapdoor is drawn as alpha, beta, gamma,
    delta, tau."""
    device = te.checked_device(device)
    alpha, beta, gamma, delta, tau = (rng.fr() for _ in range(5))
    n = fc.domain_size
    r = params.R

    # per-variable evaluations at tau (transpose matvec)
    lag = te._lagrange_at(fc.logn, tau.n, device)
    nv = len(fc.vars_sorted)
    v_at, w_at, y_at = (te.transpose_matvec(side, lag, nv)
                        for side in (fc.l, fc.r, fc.lhs))
    # L_k(tau) = beta*v_k + alpha*w_k + y_k, then /delta (mids), /gamma (ios)
    l_at = F.add(F.add(F.mont_mul(v_at, F.const_mont(beta.n, nv, FR, device), FR),
                       F.mont_mul(w_at, F.const_mont(alpha.n, nv, FR, device), FR),
                       FR), y_at, FR)
    mids_idx = np.array([fc.var_index[v] for v in sorted(mids)], dtype=np.int64)
    ios_idx = np.array([fc.var_index[v] for v in sorted(ios)], dtype=np.int64)
    dinv = pow(delta.n, -1, r)
    ginv = pow(gamma.n, -1, r)

    def scaled(idx, k):
        cols = l_at[:, torch.from_numpy(idx).to(l_at.device)]
        return F.mont_mul(cols, F.const_mont(k, len(idx), FR, device), FR)

    # host: powers of tau and the Z(tau) ladder (n entries; tau^n enters
    # the proof only through Z(tau) inside tiztd)
    ti, acc = [], 1
    for _ in range(n):
        ti.append(acc)
        acc = acc * tau.n % r
    ztd = (pow(tau.n, n, r) - 1) * dinv % r
    tizd = [ti[i] * ztd % r for i in range(n - 1)]

    # the three G1 tables share one batched inversion in to_affine
    ti1, tiztd, ltd_mid = _affine_many(
        (_fixed_base_std(ti, "g1", device),
         _fixed_base_std(tizd, "g1", device),
         _fixed_base_mont(scaled(mids_idx, dinv), "g1")))
    ti2 = C.to_affine(_fixed_base_std(ti, "g2", device))
    ltgm_io_pts = C.unpack_g1(_fixed_base_mont(scaled(ios_idx, ginv), "g1"))

    g1, g2 = G1.generator(), G2.generator()
    crs = DeviceCRS(
        alpha_g1=g1 * alpha, beta_g1=g1 * beta, beta_g2=g2 * beta,
        delta_g1=g1 * delta, delta_g2=g2 * delta,
        ti1=ti1, ti2=ti2, ltd_mid=ltd_mid, tiztd=tiztd,
        mids_idx=mids_idx.astype(np.int32), n=n)
    vkey = DeviceVKey(
        one1=g1, ltgm_io={v: ltgm_io_pts[i] for i, v in enumerate(sorted(ios))},
        one2=g2, gm=g2 * gamma, d=g2 * delta,
        ab=pairing(g1 * alpha, g2 * beta), alpha_g1=g1 * alpha, beta_g2=g2 * beta)
    return crs, vkey


def prove_device(crs: DeviceCRS, fc: flat_mod.FlatCircuit,
                 witness_mont: torch.Tensor, rng):
    """Groth16 prove (groth16.ml:123-161).  witness_mont: (8, V+1)
    Montgomery witness (flat.pack_witness layout), moved to the CRS's
    device."""
    r_sc = rng.fr()
    s_sc = rng.fr()
    witness_mont = witness_mont.to(crs.ti1[0].device)
    a_comb, b_comb, h = te.run_witness_reduction(fc, witness_mont)

    n = crs.n
    npad = msm_mod.padded_width(n)
    c_w = DEFAULT_MSM_WINDOW
    mids = torch.from_numpy(crs.mids_idx.astype(np.int64)).to(
        witness_mont.device)
    # the whole G1 side (A, B1, H, C-mid) is one batch of four MSMs over
    # three tables; the G2 MSM is launched before either result is read
    g1_tables = tuple(_fit_points(t, npad)
                      for t in (crs.ti1, crs.tiztd, crs.ltd_mid))
    g1_scalars = [_pad_scalars(s, npad) for s in (
        a_comb, b_comb, h[:, :max(1, n - 1)], witness_mont[:, mids])]
    g1_resolve = msm_mod.msm_many_staged_deferred(
        g1_tables, g1_scalars, pmap=(0, 0, 1, 2), group="g1", c=c_w)
    b_resolve = _msm_device_deferred(crs.ti2, b_comb, "g2", c=c_w)
    A_sum, B1_sum, H_sum, Cmid = C.unpack_g1(g1_resolve())
    (B_sum,) = C.unpack_g2(b_resolve())

    a = crs.alpha_g1 + A_sum + crs.delta_g1 * r_sc
    b = crs.beta_g2 + B_sum + crs.delta_g2 * s_sc
    b1 = crs.beta_g1 + B1_sum + crs.delta_g1 * s_sc
    c = (Cmid + H_sum + a * s_sc + b1 * r_sc - crs.delta_g1 * (r_sc * s_sc))
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

def host_point(p):
    """A host point of either package -> this package's, through its
    compressed bytes (48 for G1, 96 for G2)."""
    raw = p.to_compressed_bytes()
    return (G1 if len(raw) == 48 else G2).of_compressed_bytes(raw)


def crs_from_jax(jcrs, device=None) -> DeviceCRS:
    """A JAX-package DeviceCRS (its arrays read as numpy, its host points
    through their bytes) -> this port's, on `device` (default: the card)."""
    device = te.checked_device(device)
    pts = {name: C.from_jax(tuple(np.asarray(x) for x in getattr(jcrs, name)),
                            device) for name in _CRS_POINTS}
    return DeviceCRS(
        **{k: host_point(getattr(jcrs, k)) for k in
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
