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
`to_affine`.  Prove: the witness reduction, one batch of 6 G1 MSMs (8 with
ZK) and one batch of 2 G2 MSMs, both launched before either is resolved,
then the host fold of the tail variables and the ZK randomisation.
Verify: 13 host pairings (`protocols.pinocchio.verify`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import params
from ..core import flat as flat_mod
from ..engine import torch_engine as te
from ..golden.curve import G1, G2
from ..golden.field import Fr
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..params import FR
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
    card)."""
    device = te.checked_device(device)
    rv, rw, s, av, aw, ay, b, gm = (rng.fr() for _ in range(8))
    ry = rv * rw

    n = fc.domain_size
    r = params.R
    t = (pow(s.n, n, r) - 1) % r    # target(s), Z = x^n - 1 on the domain

    lag = te._lagrange_at(fc.logn, s.n, device)
    V = len(fc.vars_sorted)
    v_at, w_at, y_at = (te.transpose_matvec(side, lag, V)
                        for side in (fc.l, fc.r, fc.lhs))
    vv_s, ww_s, yy_s, vav_s, waw_s, yay_s, bvwy_s = _scalar_tables(
        v_at, w_at, y_at, rv, rw, ry, av, aw, ay, b)

    mids_idx = np.array([fc.var_index[v] for v in sorted(mids)],
                        dtype=np.int64)
    ios_idx = np.array([fc.var_index[v] for v in sorted(ios)],
                       dtype=np.int64)
    mid_cols = torch.from_numpy(mids_idx).to(device)
    io_cols = torch.from_numpy(ios_idx).to(device)

    fb = gd._fixed_base_mont

    # the all-variable tables hold the MSM family's width on the device;
    # the variables beyond it become host tails
    n_main = min(V, msm_mod.padded_width(max(n, len(mids_idx))))
    ti, acc = [], 1
    for _ in range(n):      # s^0..s^(n-1); s^n enters only through t1
        ti.append(acc)
        acc = acc * s.n % r
    vv_p, yy_p, vav_p, yay_p, bvwy_p, v_all_p, w_all_p, si = gd._affine_many(
        [fb(tab[:, mid_cols], "g1") for tab in (vv_s, yy_s, vav_s, yay_s,
                                                bvwy_s)]
        + [fb(v_at[:, :n_main], "g1"), fb(w_at[:, :n_main], "g1"),
           gd._fixed_base_std(ti, "g1", device)])
    ww_p, waw_p, si2 = gd._affine_many(
        [fb(ww_s[:, mid_cols], "g2"), fb(waw_s[:, mid_cols], "g2"),
         gd._fixed_base_std(ti, "g2", device)])
    if n_main < V:
        v_all_tail = C.unpack_g1(fb(v_at[:, n_main:], "g1"))[:V - n_main]
        w_all_tail = C.unpack_g1(fb(w_at[:, n_main:], "g1"))[:V - n_main]
    else:
        v_all_tail, w_all_tail = [], []

    # io points are few: the same device path, unpacked to host points
    nio = len(ios_idx)
    vv_io = C.unpack_g1(fb(vv_s[:, io_cols], "g1"))[:nio]
    ww_io = C.unpack_g2(fb(ww_s[:, io_cols], "g2"))[:nio]
    yy_io = C.unpack_g1(fb(yy_s[:, io_cols], "g1"))[:nio]

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
    moved to the proving key's device."""
    dev = pkey.si[0].device
    witness_mont = witness_mont.to(dev)
    _a, _b, h = te.run_witness_reduction(fc, witness_mont)

    n = pkey.n
    V = len(fc.vars_sorted)
    n_main = V - len(pkey.v_all_tail)
    c_mid = witness_mont[:, torch.from_numpy(pkey.mids_idx).to(dev)]
    c_all = witness_mont[:, :n_main]
    npad = msm_mod.padded_width(max(pkey.si[0].shape[-1], c_mid.shape[-1],
                                    n_main if zk else 1))

    def pts(p):
        return gd._fit_points(p, npad)

    def sc(x):
        return gd._pad_scalars(x, npad)

    g1_tables = [pkey.vv, pkey.yy, pkey.si, pkey.vav, pkey.yay, pkey.bvwy]
    g1_scalars = [c_mid, c_mid, h[:, :max(1, n - 1)], c_mid, c_mid, c_mid]
    if zk:
        g1_tables += [pkey.v_all, pkey.w_all]
        g1_scalars += [c_all, c_all]
    # launch both batches before either is resolved: resolving reads the
    # collision flag, a host sync
    g1_resolve = msm_mod.msm_many_staged_deferred(
        tuple(pts(p) for p in g1_tables), [sc(x) for x in g1_scalars],
        pmap=tuple(range(len(g1_tables))), group="g1",
        c=gd.DEFAULT_MSM_WINDOW)
    g2_resolve = msm_mod.msm_many_staged_deferred(
        (pts(pkey.ww), pts(pkey.waw)), [sc(c_mid), sc(c_mid)], pmap=(0, 1),
        group="g2", c=gd.DEFAULT_MSM_WINDOW)
    g1_pts = C.unpack_g1(g1_resolve())
    ww, waww = C.unpack_g2(g2_resolve())
    vv, yy, h_pt, vavv, yayy, bvwy = g1_pts[:6]

    if not zk:
        return Proof(vv=vv, ww=ww, yy=yy, h=h_pt,
                     vavv=vavv, waww=waww, yayy=yayy, bvwy=bvwy)

    # ZK randomisation (pinocchio.ml:427-514)
    dv, dw, dy = rng.fr(), rng.fr(), rng.fr()
    v_all, w_all = g1_pts[6:]
    if pkey.v_all_tail:
        tail = [Fr(x) for x in F.unpack_mont(witness_mont[:, n_main:V], FR)]
        v_all = v_all + G1.dot(pkey.v_all_tail, tail)
        w_all = w_all + G1.dot(pkey.w_all_tail, tail)
    h2 = (h_pt + v_all * dw + w_all * dv + pkey.t1 * (dv * dw)
          - G1.generator() * dy)
    return Proof(
        vv=vv + pkey.vt * dv,
        ww=ww + pkey.wt * dw,
        yy=yy + pkey.yt * dy,
        h=h2,
        vavv=vavv + pkey.vavt * dv,
        waww=waww + pkey.wawt * dw,
        yayy=yayy + pkey.yayt * dy,
        bvwy=bvwy + pkey.vbt * dv + pkey.wbt * dw + pkey.ybt * dy)


def pkey_from_jax(jpk, device=None) -> DevicePKey:
    """A JAX-package DevicePKey (its arrays read as numpy, its host points
    through their bytes) -> this port's, on `device` (default: the card)."""
    device = te.checked_device(device)
    batches = {name: C.from_jax(tuple(np.asarray(x) for x in
                                      getattr(jpk, name)[:2]), device)
               for name in _BATCHES}
    singles = {name: gd.host_point(getattr(jpk, name)) for name in _SINGLES}
    return DevicePKey(
        **batches, **singles,
        v_all_tail=[gd.host_point(p) for p in jpk.v_all_tail],
        w_all_tail=[gd.host_point(p) for p in jpk.w_all_tail],
        mids_idx=np.asarray(jpk.mids_idx, dtype=np.int64), n=int(jpk.n))

