"""Device-resident Pinocchio Protocol 2 (NonZK and ZK) on PyTorch tensors.

Counterpart of `zukelang_tpu/protocols/pinocchio_device.py`: the proving
key and the prover state live on the device as limb tensors; only the 8
proof points and the small verifying key come back to the host.  The
trapdoor is drawn in the reference's order rv, rw, s, av, aw, ay, b, gm
(pinocchio.ml:83-91) and the ZK prove adds dv, dw, dy (:428-430), so under
the same injected rng the proof is byte-equal to the JAX package's and to
its golden `Pinocchio` (`zukelang_tpu/protocols/pinocchio.py`).

Keygen: Lagrange values at s, three transpose matvecs (every QAP
polynomial at s), the per-variable scalar tables (K1 products), 12+
fixed-base batches (`ops.msm.fixed_base_mul`: K5 from 128 elements, K3
below, which takes the io batches and the all-variable tails) and
`to_affine`, under a span `zk.keygen`, through the steps of
`protocols.device`.  Prove (a span `zk.prove`): `device.prove` runs the
witness reduction and the MSMs that `msms` states, one batch of 6 G1 MSMs
(8 with ZK) and one batch of 2 G2 MSMs, both launched before either is
resolved, then `proof_of_sums` makes the proof, with ZK the fold of the
tail variables and the randomisation in the port's host library
(`zk_fold`: one call of `native.pinocchio_zk_fold`).  Verify: 13 host
pairings (`protocols.pinocchio.verify`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import native, params, util
from ..core import flat as flat_mod
from ..engine import torch_engine as te
from ..golden.curve import G1, G2
from ..golden.field import Fr
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..params import FR
from . import device as steps
from . import groth16_device as gd
from .pinocchio import Proof, VKey, verify  # noqa: F401  (verify re-exported)

_BATCHES = ("vv", "ww", "yy", "vav", "waw", "yay", "bvwy", "si", "si2",
            "v_all", "w_all")
_SINGLES = ("vt", "wt", "yt", "vavt", "wawt", "yayt", "vbt", "wbt", "ybt",
            "t1")


@dataclass
class DevicePKey:
    """pinocchio.ml:37-60 layout; the per-variable maps are affine point
    batches on the device, indexed by witness column (mids in sorted
    order, padded with infinity)."""
    vv: C.AffinePoint      # {g_v^{v_k(s)}}      G1, mids
    ww: C.AffinePoint      # {g_w^{w_k(s)}}      G2
    yy: C.AffinePoint      # {g_y^{y_k(s)}}      G1
    vav: C.AffinePoint     # {g_v^{av v_k(s)}}   G1
    waw: C.AffinePoint     # {g_w^{aw w_k(s)}}   G2
    yay: C.AffinePoint     # {g_y^{ay y_k(s)}}   G1
    bvwy: C.AffinePoint    # {g^{b(rv v + rw w + ry y)}}  G1
    si: C.AffinePoint      # {g^{s^i}} i in 0..n-1  G1
    si2: C.AffinePoint     # {g2^{s^i}}          G2
    v_all: C.AffinePoint   # {g^{v_k(s)}} vars 0..n_main-1, G1 (ZK)
    w_all: C.AffinePoint
    # the all-variable tables keep n_main = min(V, MSM width) columns on
    # the device; the few variables beyond (V = n + 2 at the bench size)
    # are host points, folded in on the host by every ZK prove
    v_all_tail: List       # host G1 for vars n_main..V-1
    w_all_tail: List
    vt: G1                 # single blinding points (pinocchio.ml:142-150)
    wt: G2
    yt: G1
    vavt: G1
    wawt: G2
    yayt: G1
    vbt: G1
    wbt: G1
    ybt: G1
    t1: G1                 # g^{t(s)} (ZK h' term)
    mids_idx: np.ndarray   # witness columns of the mid variables
    n: int                 # NTT domain size (degree of the target)


def _scalar_tables(v_at, w_at, y_at, rv, rw, ry, av, aw, ay, b):
    """Per-variable exponents from (v, w, y at s), Montgomery (8, V):
    rv v, rw w, ry y, av (rv v), aw (rw w), ay (ry y), b (sum).  The
    products are K1 (`pinocchio_device._jit_scalar_tables`)."""
    nv, dev = v_at.shape[1], v_at.device

    def mm(a, k):
        return F.mont_mul(a, F.const_mont(k.n % params.R, nv, FR, dev), FR)

    vv, ww, yy = mm(v_at, rv), mm(w_at, rw), mm(y_at, ry)
    return (vv, ww, yy, mm(vv, av), mm(ww, aw), mm(yy, ay),
            mm(F.add(F.add(vv, ww, FR), yy, FR), b))


def keygen_device(fc: flat_mod.FlatCircuit, mids: Sequence, ios: Sequence,
                  rng, device=None) -> Tuple[DevicePKey, VKey]:
    """Pinocchio KeyGen (pinocchio.ml:77-189) on `device` (default: the
    card).  Runs under a span `zk.keygen` with a new keygen id."""
    device = te.checked_device(device)
    with util.stage("zk.keygen", request=util.next_request(),
                    n=fc.domain_size):
        return _keygen(fc, mids, ios, rng, device)


def _keygen(fc: flat_mod.FlatCircuit, mids: Sequence, ios: Sequence, rng,
            device) -> Tuple[DevicePKey, VKey]:
    rv, rw, s, av, aw, ay, b, gm = (rng.fr() for _ in range(8))
    ry = rv * rw

    n = fc.domain_size
    r = params.R
    t = (pow(s.n, n, r) - 1) % r    # target(s), Z = x^n - 1 on the domain

    v_at, w_at, y_at = steps.eval_at(fc, s.n, device)
    V = len(fc.vars_sorted)
    with util.stage("zk.keygen.scalar_tables"):
        vv_s, ww_s, yy_s, vav_s, waw_s, yay_s, bvwy_s = _scalar_tables(
            v_at, w_at, y_at, rv, rw, ry, av, aw, ay, b)

    mids_idx = np.array([fc.var_index[v] for v in sorted(mids)],
                        dtype=np.int64)
    ios_idx = np.array([fc.var_index[v] for v in sorted(ios)],
                       dtype=np.int64)
    mid_cols = torch.from_numpy(mids_idx).to(device)
    io_cols = torch.from_numpy(ios_idx).to(device)

    # the all-variable tables hold the MSM family's width on the device;
    # the variables beyond it become host tails
    n_main = min(V, msm_mod.padded_width(max(n, len(mids_idx))))
    ti = steps.powers(s.n, n)   # s^0..s^(n-1); s^n enters only through t1
    c = gd.DEFAULT_FB_WINDOW

    def table(batch: str, group: str, scalars) -> C.Point:
        return steps.fixed_base(group, batch, [scalars], c, device)[0]

    g1_parts = [table(name, "g1", tab[:, mid_cols]) for name, tab in (
        ("vv", vv_s), ("yy", yy_s), ("vav", vav_s), ("yay", yay_s),
        ("bvwy", bvwy_s))]
    g1_parts += [table("v_all", "g1", v_at[:, :n_main]),
                 table("w_all", "g1", w_at[:, :n_main]), table("si", "g1", ti)]
    vv_p, yy_p, vav_p, yay_p, bvwy_p, v_all_p, w_all_p, si = (
        steps.to_affine("g1", g1_parts))
    del g1_parts        # the Jacobian tables go before the G2 tables come
    ww_p, waw_p, si2 = steps.to_affine("g2", [
        table("ww", "g2", ww_s[:, mid_cols]),
        table("waw", "g2", waw_s[:, mid_cols]), table("si2", "g2", ti)])
    if n_main < V:
        v_all_tail = C.unpack_g1(table("v_all_tail", "g1",
                                       v_at[:, n_main:]))[:V - n_main]
        w_all_tail = C.unpack_g1(table("w_all_tail", "g1",
                                       w_at[:, n_main:]))[:V - n_main]
    else:
        v_all_tail, w_all_tail = [], []

    # io points are few: the same device path, unpacked to host points
    nio = len(ios_idx)
    vv_io = C.unpack_g1(table("vv_io", "g1", vv_s[:, io_cols]))[:nio]
    ww_io = C.unpack_g2(table("ww_io", "g2", ww_s[:, io_cols]))[:nio]
    yy_io = C.unpack_g1(table("yy_io", "g1", yy_s[:, io_cols]))[:nio]

    with util.stage("zk.keygen.host_points", host=True):
        g1, g2 = G1.generator(), G2.generator()
        ft = Fr(t)
        pkey = DevicePKey(
            vv=vv_p, ww=ww_p, yy=yy_p, vav=vav_p, waw=waw_p, yay=yay_p,
            bvwy=bvwy_p, si=si, si2=si2, v_all=v_all_p, w_all=w_all_p,
            v_all_tail=v_all_tail, w_all_tail=w_all_tail,
            vt=g1 * (rv * ft), wt=g2 * (rw * ft), yt=g1 * (ry * ft),
            vavt=g1 * (rv * av * ft), wawt=g2 * (rw * aw * ft),
            yayt=g1 * (ry * ay * ft),
            vbt=g1 * (rv * b * ft), wbt=g1 * (rw * b * ft),
            ybt=g1 * (ry * b * ft), t1=g1 * ft,
            mids_idx=mids_idx, n=n)
        ios_sorted = sorted(ios)
        vkey = VKey(
            one=g1, one2=g2, av=g2 * av, aw=g1 * aw, ay=g2 * ay,
            gm2=g2 * gm, bgm=g1 * (gm * b), bgm2=g2 * (gm * b),
            yt=g2 * (ry * ft),
            vv_io=dict(zip(ios_sorted, vv_io)),
            ww_io=dict(zip(ios_sorted, ww_io)),
            yy_io=dict(zip(ios_sorted, yy_io)))
    return pkey, vkey


def prove_device(pkey: DevicePKey, fc: flat_mod.FlatCircuit,
                 witness_mont: torch.Tensor, rng, zk: bool = True) -> Proof:
    """Pinocchio prove (pinocchio.ml:193-250 NonZK, :423-515 ZK).
    witness_mont: (8, V+1) Montgomery witness (flat.pack_witness layout),
    moved to the proving key's device.  Runs under a span `zk.prove` with
    a new proof id."""
    with util.stage("zk.prove", request=util.next_request()):
        tail = tail_values(pkey, fc, witness_mont, zk)
        g1, g2 = steps.prove(pkey.si[0].device, fc, witness_mont,
                             functools.partial(msms, pkey, fc, zk=zk),
                             gd.DEFAULT_MSM_WINDOW)
        return proof_of_sums(pkey, g1, g2, tail, rng, zk)


def tail_values(pkey: DevicePKey, fc: flat_mod.FlatCircuit,
                witness_mont: torch.Tensor, zk: bool) -> list:
    """The witness values of the columns beyond the all-variable tables
    (the key's tails), read where the witness is handed in (on the host,
    no read-back from the card); none without ZK."""
    V = len(fc.vars_sorted)
    return (F.unpack_mont(witness_mont[:, V - len(pkey.v_all_tail):V], FR)
            if zk and pkey.v_all_tail else [])


def msms(pkey: DevicePKey, fc: flat_mod.FlatCircuit, w: torch.Tensor,
         reduction, zk: bool) -> tuple:
    """The prove's MSMs (the statement `device.prove` and the sharded
    prover run): G1 vv, yy, h, vavv, yayy, bvwy (with ZK also the
    all-variable v_all, w_all over the key's columns), G2 ww, waww."""
    n_main = len(fc.vars_sorted) - len(pkey.v_all_tail)
    width = msm_mod.padded_width(max(pkey.si[0].shape[-1],
                                     len(pkey.mids_idx), n_main if zk else 1))
    c_mid = w[:, torch.from_numpy(pkey.mids_idx).to(w.device)]
    g1 = [(pkey.vv, c_mid), (pkey.yy, c_mid),
          (pkey.si, reduction[2][:, :max(1, pkey.n - 1)]),
          (pkey.vav, c_mid), (pkey.yay, c_mid), (pkey.bvwy, c_mid)]
    if zk:
        c_all = w[:, :n_main]
        g1 += [(pkey.v_all, c_all), (pkey.w_all, c_all)]
    return width, g1, [(pkey.ww, c_mid), (pkey.waw, c_mid)]


def proof_of_sums(pkey: DevicePKey, g1: Sequence, g2: Sequence,
                  tail: Sequence, rng, zk: bool) -> Proof:
    """The proof from the sums of `msms`' MSMs: the NonZK proof, or with
    ZK dv, dw, dy drawn and `zk_fold`."""
    vv, yy, h, vavv, yayy, bvwy = g1[:6]
    ww, waww = g2
    sums = Proof(vv=vv, ww=ww, yy=yy, h=h, vavv=vavv, waww=waww,
                 yayy=yayy, bvwy=bvwy)
    if not zk:
        return sums
    dv, dw, dy = rng.fr(), rng.fr(), rng.fr()
    return zk_fold(pkey, sums, g1[6], g1[7], tail, dv, dw, dy)


def zk_fold(pkey: DevicePKey, sums: Proof, v_all: G1, w_all: G1,
            tail: Sequence, dv, dw, dy) -> Proof:
    """The ZK proof (pinocchio.ml:427-514) from the NonZK proof's MSM sums
    (`sums`), the all-variable MSMs over the columns the key holds on the
    device (v_all, w_all), the witness values of the tail columns beyond
    them (`tail`, in order) and the prover's dv, dw, dy:
    vv + vt dv, ww + wt dw, yy + yt dy, vavv + vavt dv, waww + wawt dw,
    yayy + yayt dy, bvwy + vbt dv + wbt dw + ybt dy and
    h + V dw + W dv + t1 (dv dw) - g dy, with V and W the all-variable sums
    with the tails folded in.  One call of the host library
    (`native.pinocchio_zk_fold`), under a span `zk.prove.fold` (host)
    with the number of tail columns."""
    with util.stage("zk.prove.fold", host=True, tail=len(tail)):
        return Proof(*native.pinocchio_zk_fold(
            [pkey.vt, pkey.yt, pkey.vavt, pkey.yayt, pkey.vbt, pkey.wbt,
             pkey.ybt, pkey.t1, G1.generator()],
            [pkey.wt, pkey.wawt],
            [sums.vv, sums.yy, sums.h, sums.vavv, sums.yayy, sums.bvwy,
             v_all, w_all],
            [sums.ww, sums.waww], pkey.v_all_tail, pkey.w_all_tail, tail,
            dv, dw, dy))


def pkey_from_jax(jpk, device=None) -> DevicePKey:
    """A JAX-package DevicePKey (its arrays read as numpy, its host points
    through their bytes) -> this port's, on `device` (default: the card)."""
    device = te.checked_device(device)
    batches = {name: C.from_jax(tuple(np.asarray(x) for x in
                                      getattr(jpk, name)[:2]), device)
               for name in _BATCHES}
    singles = {name: steps.host_point(getattr(jpk, name))
               for name in _SINGLES}
    return DevicePKey(
        **batches, **singles,
        v_all_tail=[steps.host_point(p) for p in jpk.v_all_tail],
        w_all_tail=[steps.host_point(p) for p in jpk.w_all_tail],
        mids_idx=np.asarray(jpk.mids_idx, dtype=np.int64), n=int(jpk.n))

