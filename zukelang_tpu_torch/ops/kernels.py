"""The port's hand-written CUDA kernels: wrappers, plain versions, launch counts.

Each kernel replaces one Pallas kernel of `zukelang_tpu/ops/pallas_kernels.py`
(file:line in its note below) and computes what that kernel computes, in
the port's 32-bit limb layout.  Its CUDA source is in `csrc/`, built for
sm_90a by `build.py`.

Beside every kernel:
  * a plain PyTorch version (`*_plain`) of the same function.  A wrapper
    takes it only for tensors on the CPU; for a CUDA tensor it launches
    the kernel or raises.  On the card the plain versions serve only to
    check the kernels (`chip_smoke.py`).
  * a launch count, `LAUNCHES[name]`, raised by one where the wrapper
    launches the kernel and nowhere else (`reset_counts()` zeroes them).

All integer outputs of a kernel equal its plain version's bit for bit:
both run the same formulas on canonical field values, including the
garbage a collided mixed add leaves in its flagged lane.

Coordinates: a G1 coordinate is an Fq batch `(12, N)`, a G2 coordinate
`(2, 12, N)` (rows c0 then c1, 24 rows in memory).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .. import build
from ..params import FQ, FR, FieldSpec
from . import field as F

KERNELS = ("mont_mul", "point_add", "point_double", "point_madd",
           "digit_sort", "bucket_scan_rows", "jac_scan", "weighted_chunk_sums",
           "bucket_scan", "mont_mul_looped", "ntt")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_ARGTYPES = {
    "zk_mont_mul": [_I32, _P, _P, _P, _I64, _P],
    "zk_point_add": [_I32] + [_P] * 10 + [_I64, _I64, _I32, _P],
    "zk_seg_scan_small": [_I32] + [_P] * 7 + [_I32, _I32, _P],
    "zk_point_double_n": [_I32] + [_P] * 4 + [_I32] + [_P] * 3 + [_I64, _P],
    "zk_point_madd": [_I32] + [_P] * 9 + [_I64, _P],
    "zk_point_madd_chain": [_I32, _P, _P, _I64, _P, _I32, _P, _I32, _P, _P,
                            _P, _I64, _I32, _P],
    "zk_digit_sort": [_P] * 6 + [_I64, _I64, _I32, ctypes.POINTER(_I32),
                                 _P],
    "zk_bucket_scan_rows": [_I32] + [_P] * 10 + [_I32, _I64, _I64, _I32,
                                                  _P],
    "zk_jac_scan": [_I32, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I64, _P],
    "zk_weighted_chunk_sums": [_I32] + [_P] * 9 + [_I32, _I32, _I64, _P],
    "zk_bucket_scan": [_I32] + [_P] * 7 + [_I32, _I32, _I64, _I32, _P],
    "zk_mont_mul_looped": [_I32, _P, _P, _P, _I64, _P],
    "zk_fq_mul_chain": [_P, _P, _P, _I32, _P],
    # the NTT kernel (ops/ntt.py): a pointer to its NttArgs, s0, ns,
    # first, last
    "zk_ntt_pass": [_P, _I32, _I32, _I32, _I32, _P],
}


def _fn(name: str):
    lib = build.library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, cname: str, device, *args) -> None:
    rc = _fn(cname)(*args, build.stream_ptr(device))
    build.check(rc, cname)
    LAUNCHES[kernel] += 1


def _cuda_args(*ts: torch.Tensor) -> None:
    """Validate the tensors a kernel reads: int32, contiguous, one card."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}: CPU tensors take "
                         "the plain version, others must be on a CUDA card")
    for t in ts:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous int32 tensors "
                             f"on {dev} (got {t.dtype} on {t.device})")


def group_of(coord: torch.Tensor) -> str:
    """A G1 coordinate is (12, N), a G2 coordinate (2, 12, N)."""
    return "g2" if coord.dim() == 3 else "g1"


# ---------------------------------------------------------------------------
# Plain arithmetic of the plain versions (no kernel inside)
# ---------------------------------------------------------------------------

def _to16(x: torch.Tensor) -> torch.Tensor:
    """(nl, N) 32-bit limbs -> (2 nl, N) int64 16-bit digits."""
    u = F.u64(x)
    return torch.stack([u & 0xFFFF, u >> 16], dim=1).reshape(
        2 * x.shape[0], x.shape[1])


def _from16(d: torch.Tensor) -> torch.Tensor:
    d = d.reshape(d.shape[0] // 2, 2, d.shape[1])
    return F.i32(d[:, 0] | (d[:, 1] << 16))


_P16 = {}


def _p16(spec: FieldSpec, device):
    key = (spec.name, str(device))
    if key not in _P16:
        digits = [(spec.p >> (16 * i)) & 0xFFFF for i in range(2 * spec.nl)]
        _P16[key] = (digits, torch.tensor(digits, dtype=torch.int64,
                                          device=device).view(-1, 1))
    return _P16[key]


def _split_pass(v: torch.Tensor) -> torch.Tensor:
    """One local carry pass over 16-bit digits: lo + (hi shifted up)."""
    return (v & 0xFFFF) + torch.nn.functional.pad((v >> 16)[:-1],
                                                 (0, 0, 1, 0))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   spec: FieldSpec) -> torch.Tensor:
    """a*b*R^-1 mod p by CIOS in int64 lanes: a's 32-bit limbs times b's
    16-bit digits (products < 2^48, accumulators < 2^53), one 32-bit
    Montgomery digit per step.  The deferred carries are resolved at the
    end in one pass over both candidates t and t - p."""
    shape = a.shape
    nl = spec.nl
    nd = 2 * nl
    au = F.u64(a.reshape(nl, -1)).unbind(0)
    bd = _to16(b.reshape(nl, -1))
    n = bd.shape[1]
    digits, p16 = _p16(spec, a.device)
    nlo, nhi = spec.nprime & 0xFFFF, spec.nprime >> 16
    t = torch.zeros((2 * nd + 1, n), dtype=torch.int64, device=a.device)
    for i in range(nl):
        j = 2 * i
        win = t[j:j + nd]
        win.addcmul_(bd, au[i])
        low = (t[j] + ((t[j + 1] & 0xFFFF) << 16)) & F.MASK32
        m = (low * nlo + (((low * nhi) & 0xFFFF) << 16)) & F.MASK32
        win.addcmul_(p16, m)
        # t[j] + 2^16 t[j+1] is now 0 mod 2^32: move it up as one carry
        t[j + 2] += ((t[j] >> 16) + t[j + 1]) >> 16
    v = _split_pass(_split_pass(t[nd:]))     # value < 2p, digits < 2^23
    v2 = v + F._const_col(tuple(0xFFFF - x for x in digits) + (0xFFFF,),
                          2, a.device)
    v2[0] += 1
    s = F.carry_exact(torch.stack([v, v2], dim=1), 16)
    ge = s[nd + 1, 1] > 0                    # t - p carried out: t >= p
    out = torch.where(ge.unsqueeze(0), s[:nd, 1], s[:nd, 0])
    return _from16(out).reshape(shape)


def select_lanes(cond: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Per-element select over the last (batch) axis of coordinates."""
    return torch.where(cond.view((1,) * (a.dim() - 1) + (-1,)), a, b)


class FieldOps:
    """Coordinate-field vtable of the point formulas: Fq for G1, Fq2 for
    G2.  `mul(a, b, spec)` is the base-field product: `mont_mul_plain` in
    the plain versions, K1 (`field.mont_mul`) in `ops.curve`."""

    def __init__(self, group: str, mul):
        self.g2 = group == "g2"
        self.mul = mul

    def add(self, a, b):
        return F.fq2_add(a, b) if self.g2 else F.add(a, b, FQ)

    def sub(self, a, b):
        return F.fq2_sub(a, b) if self.g2 else F.sub(a, b, FQ)

    def is_zero(self, a):
        return F.fq2_is_zero(a) if self.g2 else F.is_zero(a)

    def sel(self, c, a, b):
        return select_lanes(c, a, b)

    def one(self, like):
        n = like.shape[-1]
        one = F.ones_mont(n, FQ, like.device)
        if self.g2:
            return torch.stack([one, torch.zeros_like(one)])
        return one

    def mul_many(self, xs, ys):
        """Independent products in one plain multiply."""
        n = xs[0].shape[-1]
        if not self.g2:
            r = self.mul(torch.cat(xs, -1), torch.cat(ys, -1), FQ)
            return [r[..., i * n:(i + 1) * n] for i in range(len(xs))]
        # Karatsuba for every pair: v0 = a0 b0, v1 = a1 b1, t = (a0+a1)(b0+b1),
        # all pairs side by side in one product
        k = len(xs)
        a0 = torch.cat([a[0] for a in xs] + [b[0] for b in ys], -1)
        a1 = torch.cat([a[1] for a in xs] + [b[1] for b in ys], -1)
        sums = F.add(a0, a1, FQ)
        kn = k * n
        r = self.mul(torch.cat([a0[:, :kn], a1[:, :kn], sums[:, :kn]], -1),
                     torch.cat([a0[:, kn:], a1[:, kn:], sums[:, kn:]], -1), FQ)
        v0, v1, t = r[:, :kn], r[:, kn:2 * kn], r[:, 2 * kn:]
        d = F.sub(torch.cat([v0, t], -1), torch.cat([v1, v0], -1), FQ)
        c0, c1 = d[:, :kn], F.sub(d[:, kn:], v1, FQ)
        return [torch.stack([c0[:, i * n:(i + 1) * n], c1[:, i * n:(i + 1) * n]])
                for i in range(k)]


_OPS = {g: FieldOps(g, mont_mul_plain) for g in ("g1", "g2")}


def _on_live(live: torch.Tensor, formula, ins, base):
    """`formula(*ins)` lane by lane, computed only where `live`; the other
    lanes take `base`, which holds the formula's own words there.  Most
    lanes of the plain versions' bucket sums are infinity at test sizes,
    and a formula costs the same on every lane."""
    if bool(live.all()):
        return formula(*ins)
    idx = live.nonzero().squeeze(1)
    out = [b.clone() for b in base]
    if idx.numel():
        got = formula(*(tuple(x[..., idx] for x in pt) for pt in ins))
        for o_, g_ in zip(out, got):
            o_[..., idx] = g_
    return tuple(out)


def _dbl(P, o: FieldOps):
    """dbl-2009-l on the lanes whose words are not all zero; the doubling
    of (0, 0, 0) is (0, 0, 0)."""
    live = ~(o.is_zero(P[0]) & o.is_zero(P[1]) & o.is_zero(P[2]))
    return _on_live(live, lambda p: _dbl_formula(p, o), (P,), P)


def _dbl_formula(P, o: FieldOps):
    """dbl-2009-l (a = 0), the formula of `_double_body` (pallas :237)."""
    X, Y, Z = P
    A, B = o.mul_many([X, Y], [X, Y])
    XB = o.add(X, B)
    C, t = o.mul_many([B, XB], [B, XB])
    D = o.sub(o.sub(t, A), C)
    D = o.add(D, D)
    E = o.add(o.add(A, A), A)
    Fv, YZ = o.mul_many([E, Y], [E, Z])
    X3 = o.sub(Fv, o.add(D, D))
    c8 = o.add(C, C)
    c8 = o.add(c8, c8)
    c8 = o.add(c8, c8)
    (EDX,) = o.mul_many([E], [o.sub(D, X3)])
    return X3, o.sub(EDX, c8), o.add(YZ, YZ)


def _add(P, Q, o: FieldOps):
    """add-2007-bl, its formula computed where both operands are finite:
    the sum is P where Q is infinity, else Q where P is."""
    q_inf = o.is_zero(Q[2])
    live = ~o.is_zero(P[2]) & ~q_inf
    base = tuple(o.sel(q_inf, a, b) for a, b in zip(P, Q))
    return _on_live(live, lambda p, q: _add_formula(p, q, o), (P, Q), base)


def _add_formula(P, Q, o: FieldOps):
    """add-2007-bl with every special case, the formula of
    `_point_add_kernel` (pallas :272)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2 = o.mul_many([Z1, Z2], [Z1, Z2])
    U1, U2, A1, A2 = o.mul_many([X1, X2, Y1, Y2], [Z2Z2, Z1Z1, Z2, Z1])
    S1, S2 = o.mul_many([A1, A2], [Z2Z2, Z1Z1])
    H = o.sub(U2, U1)
    r = o.sub(S2, S1)
    H2 = o.add(H, H)
    r2 = o.add(r, r)
    ZZ = o.add(Z1, Z2)
    I, Zs = o.mul_many([H2, ZZ], [H2, ZZ])
    J, V = o.mul_many([H, U1], [I, I])
    rr, S1J, Z3 = o.mul_many([r2, S1, o.sub(o.sub(Zs, Z1Z1), Z2Z2)],
                             [r2, J, H])
    X3 = o.sub(o.sub(rr, J), o.add(V, V))
    (Ym,) = o.mul_many([r2], [o.sub(V, X3)])
    Y3 = o.sub(Ym, o.add(S1J, S1J))
    p_inf = o.is_zero(Z1)
    q_inf = o.is_zero(Z2)
    same = o.is_zero(H) & o.is_zero(r) & ~p_inf & ~q_inf
    if bool(same.any()):
        dX, dY, dZ = _dbl_formula(P, o)
        X3, Y3, Z3 = o.sel(same, dX, X3), o.sel(same, dY, Y3), o.sel(same, dZ, Z3)
    X3 = o.sel(q_inf, X1, o.sel(p_inf, X2, X3))
    Y3 = o.sel(q_inf, Y1, o.sel(p_inf, Y2, Y3))
    Z3 = o.sel(q_inf, Z1, o.sel(p_inf, Z2, Z3))
    return X3, Y3, Z3


def _madd(P, Q, o: FieldOps):
    """madd-2007-bl, its formula computed where both operands are finite:
    the sum is P where Q is infinity, else (X2, Y2, 1) where P is; `same`
    is false there."""
    p_inf = o.is_zero(P[2])
    q_inf = o.is_zero(Q[0]) & o.is_zero(Q[1])
    live = ~p_inf & ~q_inf
    base = (o.sel(q_inf, P[0], Q[0]), o.sel(q_inf, P[1], Q[1]),
            o.sel(q_inf, P[2], o.one(P[2])), torch.zeros_like(live))
    return _on_live(live, lambda p, q: _madd_formula(p, q, o), (P, Q), base)


def _madd_formula(P, Q, o: FieldOps):
    """madd-2007-bl, the formula of `_madd_core` (pallas :567): Jacobian P
    plus affine Q ((0, 0) = infinity).  Returns (X3, Y3, Z3, same); lanes
    with P == Q (both finite) are garbage and flagged in `same`."""
    X1, Y1, Z1 = P
    X2, Y2 = Q
    (Z1Z1,) = o.mul_many([Z1], [Z1])
    U2, ZC = o.mul_many([X2, Z1], [Z1Z1, Z1Z1])
    (S2,) = o.mul_many([Y2], [ZC])
    H = o.sub(U2, X1)
    r = o.sub(S2, Y1)
    (HH,) = o.mul_many([H], [H])
    I = o.add(o.add(HH, HH), o.add(HH, HH))
    r2 = o.add(r, r)
    J, V, rr = o.mul_many([H, X1, r2], [I, I, r2])
    X3 = o.sub(o.sub(rr, J), o.add(V, V))
    ZH = o.add(Z1, H)
    YJ, Ym, ZHs = o.mul_many([Y1, r2, ZH], [J, o.sub(V, X3), ZH])
    Y3 = o.sub(Ym, o.add(YJ, YJ))
    Z3 = o.sub(o.sub(ZHs, Z1Z1), HH)
    p_inf = o.is_zero(Z1)
    q_inf = o.is_zero(X2) & o.is_zero(Y2)
    same = o.is_zero(H) & o.is_zero(r) & ~p_inf & ~q_inf
    X3 = o.sel(q_inf, X1, o.sel(p_inf, X2, X3))
    Y3 = o.sel(q_inf, Y1, o.sel(p_inf, Y2, Y3))
    Z3 = o.sel(q_inf, Z1, o.sel(p_inf, o.one(Z1), Z3))
    return X3, Y3, Z3, same


# ---------------------------------------------------------------------------
# K1  mont_mul
# Replaces mont_mul_pallas (pallas_kernels.py:201; kernel _mont_mul_kernel
# :132).  One thread per element, 32-bit CIOS with 64-bit products.  Bound:
# integer multiply throughput (144 / 64 32x32->64 products for Fq / Fr),
# not bytes (3 x 48 B per Fq element); nothing to stage, so no shared memory.
# ---------------------------------------------------------------------------

def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    return _mont_mul_launch("mont_mul", "zk_mont_mul", a, b, spec)


def _mont_mul_launch(kernel: str, cname: str, a, b, spec: FieldSpec):
    shape = a.shape
    a2 = a.reshape(spec.nl, -1).contiguous()
    b2 = b.reshape(spec.nl, -1).contiguous()
    _cuda_args(a2, b2)
    if a2.shape != b2.shape:
        raise ValueError(f"mont_mul shapes differ: {a.shape} vs {b.shape}")
    out = torch.empty_like(a2)
    n = a2.shape[1]
    if n:
        _launch(kernel, cname, a.device, _I32(0 if spec is FR else 1),
                build.ptr(a2), build.ptr(b2), build.ptr(out), _I64(n))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# mont_mul_looped
# Replaces _mont_mul_kernel_looped (scripts/probe_looped_kernel.py:29, call
# _looped_call :75), the TPU probe of compile time against body size.  K1's
# product with the outer limb loop rolled (`#pragma unroll 1`), in its own
# source (csrc/mont_mul_looped.cu) so its nvcc time and registers show
# apart from K1's: a's and b's limbs loaded before the loop, each row of a
# CIOS step one PTX carry chain, one element a thread, 128 threads a
# block.  Bound: at 2^20 Fq the bytes, with the limb products'
# instruction throughput close behind.  Its plain version is K1's.
# ---------------------------------------------------------------------------


def mont_mul_looped(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec
                    ) -> torch.Tensor:
    """a * b * R^-1 mod p as K1, by the looped kernel."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    return _mont_mul_launch("mont_mul_looped", "zk_mont_mul_looped", a, b,
                            spec)


def fq_mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """a * b^reps * R^-reps for one Fq element ((12, 1) each): on the card
    `reps` dependent K1 products on one thread (csrc/mont_mul.cu), the
    probe of one product's latency behind the point kernels' chain
    bounds; counted as a `mont_mul` launch.  On no path."""
    if a.shape != (FQ.nl, 1) or b.shape != (FQ.nl, 1) or reps < 0:
        raise ValueError(f"fq_mul_chain: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, {reps} reps")
    if a.device.type == "cpu":
        for _ in range(reps):
            a = mont_mul_plain(a, b, FQ)
        return a
    a, b = a.contiguous(), b.contiguous()
    _cuda_args(a, b)
    out = torch.empty_like(a)
    _launch("mont_mul", "zk_fq_mul_chain", a.device, build.ptr(a),
            build.ptr(b), build.ptr(out), _I32(reps))
    return out


# ---------------------------------------------------------------------------
# K2  point_add / point_double
# Replaces point_add_pallas / point_double_pallas (pallas_kernels.py:346,
# :359) and their G2 forms (:529, :541).  On the provers' paths both are
# bound by latency: most launches are narrow (a few to a few thousand
# points) and each point is a chain of dependent field products.  So both
# run on a group of lanes a point, each lane running some of a level's
# independent Fq products (csrc/point_lanes.cuh).
# The add (csrc/point_add.cu) takes L = `point_lanes(group, n)` lanes a
# point (G1 1 or 4; G2 1, 4 or 8: a chain of 5 / 8 Fq products against
# 16 / 48 at one thread), in three launch forms, each counted as a
# `point_add` launch:
#   `point_add(p, q)`: p + q lane by lane;
#   `point_add_carry(p, car, idx)`: p[i] + car[idx[i]], nothing added
#     where idx[i] < 0, the carry add of a chunked scan (the selection and
#     gather in the kernel);
#   `seg_scan_small(points, seg)`: the Hillis-Steele segmented scan of up
#     to SEG_SCAN_SMALL_MAX points in one launch of one block.
# The doubling (csrc/point_ops.cu) doubles point i counts[i] times in one
# kernel (`point_double_n`; `point_double` is count 1): the window
# combine's c w doublings of window w in one launch, the point kept in
# registers across the chain (G1: 3 lanes, levels of 3, 3, 1 products;
# G2: 7 lanes, 7, 6, 3).
# ---------------------------------------------------------------------------

# Fq products on the dependent chain of one add at L lanes a point, and of
# one step of K3's chain (csrc/point_lanes.cuh); L = 1 is jac_add, one
# thread.
POINT_CHAIN = {
    "add": {"g1": {1: 16, 4: 5}, "g2": {1: 48, 4: 13, 8: 8}},
    "madd": {"g1": 5, "g2": 5},
}
# The add's width model, from `profile_kernels --sweep --points-only` on
# an H100 (device times; PERF.md): the device us of one add at L lanes a
# point on a launch too narrow to queue, and the warps up to which that
# holds (beyond, the time grows with the warps).  A round of the small
# scan takes the add's step for each pass of its one block of
# SEG_SCAN_SMALL_WARPS warps over the points.
POINT_STEP_US = {"g1": {1: 30, 4: 11}, "g2": {1: 100, 4: 57, 8: 46}}
POINT_WARPS = 500
# Lanes a point the add is built for (csrc/point_add.cu).
POINT_LANES = {g: tuple(POINT_STEP_US[g]) for g in ("g1", "g2")}
# Lanes a point of K3's chain (csrc/point_madd.cu), fixed per group as the
# doubling's are: its launches (16 to 8,192 lanes) are all narrow enough
# for the widest group (the sweep in PERF.md).
MADD_CHAIN_LANES = {"g1": 4, "g2": 8}
SEG_SCAN_SMALL_MAX = 256   # points of one `seg_scan_small` launch
SEG_SCAN_SMALL_WARPS = 8   # its block (kScanSmallThreads in point_add.cu)


def point_lanes(group: str, n: int, op: str = "add") -> int:
    """Lanes a point of K2's add (op "add") or its small scan ("scan")
    over n points: the L of `POINT_LANES` with the least step x max(1,
    warps / POINT_WARPS), or for the scan the least step x passes of its
    block over the points.  A pure function of the shapes; the words do
    not depend on it (every field result is canonical)."""
    step = POINT_STEP_US[group]
    if op == "scan":
        return min(step, key=lambda L: step[L] * -(
            -n * L // (32 * SEG_SCAN_SMALL_WARPS)))
    if op != "add":
        raise ValueError(f"point_lanes: no width model for {op!r}")
    return min(step, key=lambda L: step[L] * max(
        1.0, n * L / 32 / POINT_WARPS))


def _check_lanes(group: str, lanes: int, what: str) -> None:
    if lanes not in POINT_LANES[group]:
        raise ValueError(f"{what}: {lanes} lanes a point for {group} (built: "
                         f"{POINT_LANES[group]})")


def point_add_plain(p, q):
    return _add(p, q, _OPS[group_of(p[0])])


def point_add_carry_plain(p, car, idx):
    """p[i] + car[idx[i]], car at infinity where idx[i] < 0."""
    take = idx >= 0
    j = idx.clamp(min=0).to(torch.int64)
    q = tuple(select_lanes(take, c[..., j], torch.zeros_like(x))
              for c, x in zip(car, p))
    return point_add_plain(p, q)


def hs_rounds(points, seg, add, span: int = None):
    """Inclusive segmented prefix sum along the batch axis (seg sorted) by
    the Hillis-Steele rounds of the JAX package's `_hs_segmented_scan`
    (zukelang_tpu/ops/msm.py:119-143), each round one `add` of the
    batch and its shift.  A lane whose shifted partner lies in another
    segment adds infinity (Z = 0: the sum is the lane's own point, word
    for word), so the plain formula runs only where a round adds.  `span`
    bounds the longest segment (default the batch): the rounds of shifts
    at or beyond it change nothing and are left out."""
    n = seg.shape[-1]
    idx = torch.arange(n, device=seg.device)
    X, Y, Z = points
    for d in range(max(1, ((span or n) - 1).bit_length())):
        sh = 1 << d
        valid = (idx >= sh) & (seg == torch.roll(seg, sh))
        prev = (torch.roll(X, sh, dims=-1), torch.roll(Y, sh, dims=-1),
                torch.roll(Z, sh, dims=-1) * valid)
        X, Y, Z = add((X, Y, Z), prev)
    return X, Y, Z


def seg_scan_small_plain(points, seg):
    """`hs_rounds` on `point_add_plain`."""
    return hs_rounds(points, seg, point_add_plain)


def point_double_plain(p):
    return _dbl(p, _OPS[group_of(p[0])])


class _IntField:
    """Montgomery-domain arithmetic of `_dbl_formula` on Python integers:
    Fq (ints) for G1, Fq2 ((c0, c1) pairs, u^2 = -1) for G2.  Every
    result is the canonical field value, so the words equal the torch
    formula's."""

    def __init__(self, g2: bool):
        self.g2, self.p = g2, FQ.p
        self.rinv = pow(FQ.R, -1, FQ.p)

    def mul(self, a, b):
        p, r = self.p, self.rinv
        if not self.g2:
            return a * b * r % p
        return ((a[0] * b[0] - a[1] * b[1]) * r % p,
                (a[0] * b[1] + a[1] * b[0]) * r % p)

    def add(self, a, b):
        if not self.g2:
            return (a + b) % self.p
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        if not self.g2:
            return (a - b) % self.p
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul_many(self, xs, ys):
        return [self.mul(x, y) for x, y in zip(xs, ys)]


def point_double_n_plain(p, counts):
    """Point i doubled counts[i] times (counts an int, or an (N,) integer
    tensor; 0 or less keeps the point): the chained formula of the kernel
    run point by point on Python integers.  A chain is sequential, so the
    torch formula would pay its per-operation cost counts times whatever
    the width; the arithmetic is exact, and the words are the torch
    formula's (`point_double_plain` at every step)."""
    g2 = group_of(p[0]) == "g2"
    f = _IntField(g2)
    n = p[0].shape[-1]
    cs = (counts.tolist() if isinstance(counts, torch.Tensor)
          else [int(counts)] * n)

    def ints(coord):
        if not g2:
            return F.unpack(coord, FQ)
        return list(zip(F.unpack(coord[0], FQ), F.unpack(coord[1], FQ)))

    cols = [ints(c) for c in p]
    out = [[], [], []]
    for i in range(n):
        pt = (cols[0][i], cols[1][i], cols[2][i])
        for _ in range(cs[i]):
            pt = _dbl_formula(pt, f)
        for o_, v in zip(out, pt):
            o_.append(v)

    def packed(vals, like):
        if not g2:
            return F.pack(vals, FQ, like.device)
        return torch.stack([F.pack([v[k] for v in vals], FQ, like.device)
                            for k in (0, 1)])
    return tuple(packed(v, c) for v, c in zip(out, p))


def _coords(pts, what: str):
    """Contiguous coordinates of one batch, all of one shape."""
    ins = [x.contiguous() for x in pts]
    if any(x.shape != ins[0].shape for x in ins):
        raise ValueError(f"{what}: coordinate shapes differ")
    return ins


def _add_launch(p, q, idx, lanes):
    group = group_of(p[0])
    ps, qs = _coords(p, "point_add"), _coords(q, "point_add")
    n, nq = ps[0].shape[-1], qs[0].shape[-1]
    if ps[0].shape[:-1] != qs[0].shape[:-1] or (idx is None and nq != n):
        raise ValueError(f"point_add: operands {tuple(ps[0].shape)} and "
                         f"{tuple(qs[0].shape)}")
    lanes = point_lanes(group, n) if lanes is None else lanes
    _cuda_args(*ps, *qs, *([idx] if idx is not None else []))
    outs = [torch.empty_like(ps[0]) for _ in range(3)]
    if n:
        _launch("point_add", "zk_point_add", ps[0].device,
                _I32(int(group == "g2")), *(build.ptr(x) for x in ps + qs),
                build.ptr(idx) if idx is not None else _P(None),
                *(build.ptr(x) for x in outs), _I64(n), _I64(nq),
                _I32(lanes))
    return tuple(outs)


def point_add(p, q, lanes: int = None):
    """p + q lane by lane (add-2007-bl, every special case); lanes a point
    on the card: `point_lanes` unless given."""
    if lanes is not None:
        _check_lanes(group_of(p[0]), lanes, "point_add")
    if p[0].device.type == "cpu":
        return point_add_plain(p, q)
    return _add_launch(p, q, None, lanes)


def point_add_carry(p, car, idx: torch.Tensor, lanes: int = None):
    """p[i] + car[idx[i]] lane by lane, nothing added where idx[i] < 0: a
    chunked scan's carry add (idx (n,) int32, entries below car's
    width)."""
    if idx.dim() != 1 or idx.shape[0] != p[0].shape[-1]:
        raise ValueError(f"point_add_carry: idx {tuple(idx.shape)} for "
                         f"{p[0].shape[-1]} points")
    if lanes is not None:
        _check_lanes(group_of(p[0]), lanes, "point_add_carry")
    if p[0].device.type == "cpu":
        return point_add_carry_plain(p, car, idx)
    return _add_launch(p, car, idx.contiguous(), lanes)


def seg_scan_small(points, seg: torch.Tensor, lanes: int = None):
    """Inclusive segmented prefix sum of n <= SEG_SCAN_SMALL_MAX points
    along the batch axis (seg (n,) sorted ids, int32), in one launch: the
    Hillis-Steele rounds of `seg_scan_small_plain`, word for word."""
    n = seg.shape[-1]
    if (seg.dim() != 1 or not 1 <= n <= SEG_SCAN_SMALL_MAX
            or points[0].shape[-1] != n):
        raise ValueError(f"seg_scan_small: {points[0].shape[-1]} points, "
                         f"seg {tuple(seg.shape)} (at most "
                         f"{SEG_SCAN_SMALL_MAX})")
    if lanes is not None:
        _check_lanes(group_of(points[0]), lanes, "seg_scan_small")
    if points[0].device.type == "cpu":
        return seg_scan_small_plain(points, seg)
    return _seg_scan_small_launch(points, seg, lanes)


def _seg_scan_small_launch(points, seg, lanes):
    n = seg.shape[-1]
    group = group_of(points[0])
    ins = _coords(points, "seg_scan_small")
    segc = seg.contiguous()
    lanes = point_lanes(group, n, "scan") if lanes is None else lanes
    _cuda_args(*ins, segc)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    _launch("point_add", "zk_seg_scan_small", ins[0].device,
            _I32(int(group == "g2")), *(build.ptr(x) for x in ins),
            build.ptr(segc), *(build.ptr(x) for x in outs), _I32(n),
            _I32(lanes))
    return tuple(outs)


def point_double(p):
    return point_double_n(p, 1)


def point_double_n(p, counts):
    """Point i of the batch doubled counts[i] times (counts an (N,) int32
    tensor, or one int for every point; 0 or less keeps the point), in one
    launch."""
    group = group_of(p[0])
    n = p[0].shape[-1]
    tensor = isinstance(counts, torch.Tensor)
    if tensor and (counts.dim() != 1 or counts.shape[0] != n):
        raise ValueError(f"point_double_n: counts {tuple(counts.shape)} "
                         f"for {n} points")
    if p[0].device.type == "cpu":
        return point_double_n_plain(p, counts)
    ins = [x.contiguous() for x in p]
    cnt = counts.contiguous() if tensor else None
    _cuda_args(*ins, *([cnt] if tensor else []))
    if any(x.shape != ins[0].shape for x in ins):
        raise ValueError("point_double_n coordinate shapes differ")
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("point_double", "zk_point_double_n", ins[0].device,
                _I32(int(group == "g2")),
                *(build.ptr(x) for x in ins),
                build.ptr(cnt) if tensor else _P(None),
                _I32(0 if tensor else int(counts)),
                *(build.ptr(x) for x in outs), _I64(n))
    return tuple(outs)


# ---------------------------------------------------------------------------
# K3  point_madd, point_madd_chain
# Replaces point_madd_pallas / point_madd_pallas_g2 (pallas_kernels.py:663,
# :680; kernels _point_madd_kernel / _point_madd_kernel2 :594, :615):
# madd-2007-bl (11 field products), csrc/point_madd.cu.
#   `point_madd(p, q)`: the Pallas contract, one thread a lane; the flag
#     marks the doubling-degenerate lanes (P == Q, both finite), whose
#     output is the formula's garbage exactly as in the Pallas kernel
#     (`ops.curve.point_madd` repairs them with K2's doubling).
#   `point_madd_chain(table, steps, ...)`: the paths' form.  Each lane sums
#     `steps` affine points in one launch with the doubling case resolved
#     in the kernel, on `MADD_CHAIN_LANES[group]` lanes a point: a
#     fixed-base batch's window loop (the table entries gathered in the
#     kernel from the digits) or phase 1 of the chunked bucket sums
#     (restarts at segment changes, every step stored).  Bound: the chain
#     of steps on launches of 16 to 8,192 lanes; it replaces a loop of one
#     K3 launch, one host read of the flags and one Python step a step.
# ---------------------------------------------------------------------------

def point_madd_plain(p, q):
    """Jacobian p + affine q -> ((X3, Y3, Z3), same), as `point_madd`."""
    X3, Y3, Z3, same = _madd(p, q, _OPS[group_of(p[0])])
    return (X3, Y3, Z3), same


def point_madd(p, q):
    """Jacobian p (3 coordinates) + affine q (2; (0, 0) = infinity) ->
    ((X3, Y3, Z3), same), `same` an (N,) bool mask of the lanes that hit
    the doubling case."""
    if p[0].device.type == "cpu":
        return point_madd_plain(p, q)
    g2 = group_of(p[0]) == "g2"
    ins = _coords((*p, *q), "point_madd")
    _cuda_args(*ins)
    n = ins[0].shape[-1]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    flag = torch.empty(n, dtype=torch.int32, device=ins[0].device)
    if n:
        _launch("point_madd", "zk_point_madd", ins[0].device, _I32(int(g2)),
                *(build.ptr(x) for x in ins), *(build.ptr(x) for x in outs),
                build.ptr(flag), _I64(n))
    return tuple(outs), flag != 0


def _affine_to_jac(q, o: FieldOps):
    X, Y = q
    inf = o.is_zero(X) & o.is_zero(Y)
    return X, Y, o.sel(inf, torch.zeros_like(X), o.one(X))


def _chain_columns(width: int, steps: int, digits, c: int, device):
    """(steps, lanes) int64 table columns of each step of each lane."""
    w = torch.arange(steps, dtype=torch.int64, device=device)[:, None]
    if digits is not None:
        return digits.to(torch.int64) + (w << c)
    lanes = torch.arange(width // steps, dtype=torch.int64, device=device)
    return lanes[None, :] * steps + w


def point_madd_chain_plain(table, steps: int, digits=None, c: int = 0,
                           seg=None, keep: bool = False):
    """The loop of `point_madd_plain` with the doubling fix-up
    (`point_double_plain` of the accumulator where a lane is flagged),
    step by step, with the restarts and stores of `point_madd_chain`."""
    o = _OPS[group_of(table[0])]
    tX, tY = table
    cols = _chain_columns(tX.shape[-1], steps, digits, c, tX.device)

    def at(w):
        return tX[..., cols[w]], tY[..., cols[w]]

    acc = _affine_to_jac(at(0), o)
    outs = [acc]
    for w in range(1, steps):
        q = at(w)
        added, same = point_madd_plain(acc, q)
        if bool(same.any()):
            dbl = point_double_plain(acc)
            added = tuple(o.sel(same, d, a) for d, a in zip(dbl, added))
        if seg is not None:
            restart = seg[cols[w]] != seg[cols[w] - 1]
            added = tuple(o.sel(restart, r, a)
                          for r, a in zip(_affine_to_jac(q, o), added))
        acc = added
        outs.append(acc)
    if not keep:
        return tuple(acc)
    return tuple(torch.stack([s[i] for s in outs], dim=-1).reshape(
        acc[i].shape[:-1] + (-1,)) for i in range(3))


def point_madd_chain(table, steps: int, digits: torch.Tensor = None,
                     c: int = 0, seg: torch.Tensor = None, keep: bool = False):
    """Lane e sums `steps` affine points of `table` ((X, Y) of width T,
    (0, 0) = infinity) by mixed adds, in one launch:
      * with digits (steps, n) int32: step w takes column
        (w << c) + digits[w, e] (a fixed-base window table); n lanes;
      * without: step w takes column e * steps + w (chunks of the flat
        batch); T / steps lanes, and with seg (T,) int32 step w restarts
        from its point where seg changes from step w - 1.
    The sum starts at step 0's point; where an add hits the doubling case
    the accumulator is doubled, as `ops.curve.point_madd` does.  Returns
    the Jacobian sums (lanes), or with keep every step's sum in the chunk
    layout (lane e's step w at column e * steps + w)."""
    tX = table[0]
    T = tX.shape[-1]
    bad = (steps < 1 or (digits is None and T % steps)
           or (digits is not None and (digits.dim() != 2
                                       or digits.shape[0] != steps
                                       or seg is not None))
           or (seg is not None and seg.shape != (T,)))
    if bad:
        raise ValueError(f"point_madd_chain: table {tuple(tX.shape)}, "
                         f"{steps} steps, digits "
                         f"{None if digits is None else tuple(digits.shape)}, "
                         f"seg {None if seg is None else tuple(seg.shape)}")
    if tX.device.type == "cpu":
        return point_madd_chain_plain(table, steps, digits, c, seg, keep)
    return _chain_launch(table, steps, digits, c, seg, keep)


def _chain_launch(table, steps, digits, c, seg, keep):
    T = table[0].shape[-1]
    group = group_of(table[0])
    n = digits.shape[1] if digits is not None else T // steps
    ins = _coords(table, "point_madd_chain")
    dig = digits.contiguous() if digits is not None else None
    sg = seg.contiguous() if seg is not None else None
    _cuda_args(*ins, *(x for x in (dig, sg) if x is not None))
    width = n * steps if keep else n
    outs = [torch.empty(ins[0].shape[:-1] + (width,), dtype=torch.int32,
                        device=ins[0].device) for _ in range(3)]
    if n:
        _launch("point_madd", "zk_point_madd_chain", ins[0].device,
                _I32(int(group == "g2")), build.ptr(ins[0]),
                build.ptr(ins[1]), _I64(T),
                build.ptr(dig) if dig is not None else _P(None), _I32(c),
                build.ptr(sg) if sg is not None else _P(None), _I32(steps),
                *(build.ptr(x) for x in outs), _I64(n), _I32(int(keep)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# K4  digit_sort
# Replaces bitonic_argsort / bitonic_sort_pairs (pallas_kernels.py:1173,
# :1139; kernel _bitonic_kernel :1083, cross passes :1125).  A stable LSD
# radix sort of each row on its key, at most 8 bits per pass
# (`radix_passes`): per pass, per-tile digit counts, a per-row scan of
# them, and a scatter in which every warp ranks its keys with
# __match_any_sync and each tile is staged in shared memory so that a
# digit's run is written to consecutive addresses.  Each row is cut into
# tiles of 2048 keys, one block each, so a call fills the card even with
# one row.  Bound: bytes.  One wrapper call runs 3 kernels per pass and
# counts one launch.  Returns (sorted keys, order).
# ---------------------------------------------------------------------------

SORT_TILE = 2048      # keys per block of K4 (kTile in csrc/digit_sort.cu)
_SORT_DIGITS = 256    # counters per tile and pass (kMaxDigits)


def radix_passes(nkeys: int) -> Tuple[int, ...]:
    """Bits of each K4 pass for keys in [0, nkeys): the key's width split
    into the fewest passes of at most 8 bits, the low passes the wider."""
    bits = max(1, (nkeys - 1).bit_length())
    npass = -(-bits // 8)
    return tuple(bits // npass + (1 if p < bits % npass else 0)
                 for p in range(npass))


@functools.lru_cache(maxsize=64)
def _sort_plan(nkeys: int):
    """(passes, the bits of each as a C int array) for the K4 call."""
    bits = radix_passes(nkeys)
    return len(bits), (ctypes.c_int * len(bits))(*bits)


def digit_sort_plain(keys: torch.Tensor, nkeys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    sk, order = torch.sort(keys, dim=-1, stable=True)
    return sk, order.to(torch.int32)


def digit_sort(keys: torch.Tensor, nkeys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys: (rows, n) int32 in [0, nkeys) -> (sorted keys, order), each
    (rows, n) int32, sorted along the last axis (stable)."""
    if keys.device.type == "cpu":
        return digit_sort_plain(keys, nkeys)
    k = keys.contiguous()
    _cuda_args(k)
    rows, n = k.shape
    if not 1 <= nkeys <= 1 << 31 or rows > 65535:
        raise ValueError(f"digit_sort: {rows} rows of keys in [0, {nkeys}) "
                         "are not supported")
    out = torch.empty((2, rows, n), dtype=torch.int32, device=k.device)
    sk, order = out[0], out[1]
    if rows and n:
        npass, bits = _sort_plan(nkeys)
        tiles = -(-n // SORT_TILE)
        # counts (rows, 256, tiles), then tmp keys and values for 2+ passes
        ncount = rows * _SORT_DIGITS * tiles
        scratch = torch.empty(ncount + (2 * rows * n if npass > 1 else 0),
                              dtype=torch.int32, device=k.device)
        base = scratch.data_ptr()
        tmp = ((_P(base + 4 * ncount), _P(base + 4 * (ncount + rows * n)))
               if npass > 1 else (_P(None), _P(None)))
        _launch("digit_sort", "zk_digit_sort", k.device, build.ptr(k),
                build.ptr(sk), build.ptr(order), _P(base), *tmp, _I64(rows),
                _I64(n), _I32(npass), bits)
    return sk, order


# ---------------------------------------------------------------------------
# K5  bucket_scan_rows
# Replaces bucket_scan_rows (pallas_kernels.py:1296; kernel
# _seg_scan_kernel2 :1192, call _seg_scan2_call :1253).  One thread per
# chunk of K positions; at each step the thread gathers its point's row
# from the affine row table itself (16-byte loads; the block's indices and
# segment ids staged in shared memory first) and runs the segmented mixed
# add with the accumulator and the collision flag in registers, in place
# of the Pallas grid's sequential t axis.  It writes only what the MSM
# reads: each chunk's final accumulator and, with nb, each bucket's
# in-chunk tail.  Bound: 11 field products per continuing step.
# ---------------------------------------------------------------------------

def _row_coord(v: torch.Tensor, group: str) -> torch.Tensor:
    """(lanes, rows) words of one coordinate -> (12, lanes) / (2, 12, lanes)."""
    v = v.t()
    return v.reshape(2, v.shape[0] // 2, v.shape[1]) if group == "g2" else v


def _jac_of_affine(cx, cy, o: FieldOps):
    """Affine (0, 0) = infinity -> Jacobian with Z = 1, or Z = 0."""
    cinf = o.is_zero(cx) & o.is_zero(cy)
    return cx, cy, o.sel(cinf, torch.zeros_like(cx), o.one(cx))


def _segmented_madds(g, s, group: str):
    """The scan of K5 and K8 in torch ops: g (lanes, K, 2 R) the affine
    rows of each lane's K steps, s (lanes, K) segment ids or None (one
    segment per lane).  Yields (t, accumulator, flag) after each step."""
    o = _OPS[group]
    lanes, K, R2 = g.shape
    R = R2 // 2
    flag = torch.zeros(lanes, dtype=torch.bool, device=g.device)
    acc = None
    for t in range(K):
        CX, CY, CZ = _jac_of_affine(_row_coord(g[:, t, :R], group),
                                    _row_coord(g[:, t, R:], group), o)
        if t == 0:
            acc = (CX, CY, CZ)
        else:
            cont = (s[:, t] == s[:, t - 1] if s is not None else
                    torch.ones(lanes, dtype=torch.bool, device=g.device))
            X3, Y3, Z3, col = _madd(acc, (CX, CY), o)
            acc = (o.sel(cont, X3, CX), o.sel(cont, Y3, CY),
                   o.sel(cont, Z3, CZ))
            flag = flag | (col & cont)
        yield t, acc, flag


def bucket_scan_rows_plain(rows, idx, seg, K: int, group: str,
                           nb: int = None):
    """The kernel's steps in torch ops, in its order, on the same gather."""
    B, n = idx.shape
    M = n // K
    lanes = B * M
    R = rows.shape[1] // 2
    dev = rows.device
    g = rows[idx.reshape(-1).to(torch.int64)].reshape(lanes, K, 2 * R)
    s = seg.reshape(lanes, K) if seg is not None else None
    if nb is not None:
        buckets = [torch.zeros((R, B * nb), dtype=torch.int32, device=dev)
                   for _ in range(3)]
        # the segment id after each step: the next step's, and after the
        # chunk's last the next chunk's first in the same row, else -1
        after = torch.full((lanes, 1), -1, dtype=s.dtype, device=dev)
        more = (torch.arange(lanes, device=dev) % M) + 1 < M
        after[:-1, 0] = torch.where(more[:-1], s[1:, 0], after[:-1, 0])
        s_next = torch.cat([s[:, 1:], after], dim=1)
        col0 = (torch.arange(lanes, device=dev) // M) * nb
    for t, acc, flag in _segmented_madds(g, s, group):
        if nb is not None:
            end = s_next[:, t] != s[:, t]
            cols = (col0 + s[:, t])[end]
            for bkt, a in zip(buckets, acc):
                bkt[:, cols] = a.reshape(R, lanes)[:, end]
    tails = tuple(a.reshape(R, lanes) for a in acc)
    return tails, (tuple(buckets) if nb is not None else None), flag


def bucket_scan_rows(rows, idx, seg, K: int, group: str, nb: int = None):
    """Segmented mixed-add scan over rows gathered in the kernel.

    rows (Nrows, 2 R) int32: affine [X; Y] points, R = 12 (G1) / 24 (G2)
    words a coordinate, (0, 0) = infinity.  idx (B, n) int32 row indices
    in [0, Nrows), n = M K: block row b is M chunks of K positions, chunk
    (lane) l = b M + m takes positions m K .. m K + K - 1.  seg (B, n)
    int32 sorted segment ids (>= 0) where the accumulator restarts at each
    change, or None for one segment per chunk.  Returns (tails, buckets,
    flag): tails 3 x (R, B M), each chunk's final accumulator; with nb
    (seg ids in [0, nb)), buckets 3 x (R, B nb), column b nb + d the
    accumulator where row b's segment d ends inside its chunk (zeros where
    row b has no d), else None; flag (B M,) bool, the chunks whose mixed
    add hit the doubling case (their results are garbage)."""
    B, n = idx.shape if idx.dim() == 2 else (None, None)
    R2 = 48 if group == "g2" else 24
    if (B is None or K < 1 or K > 128 or n % K or rows.dim() != 2
            or rows.shape[1] != R2
            or (seg is not None and seg.shape != idx.shape)
            or (nb is not None and (seg is None or nb < 1))):
        raise ValueError(f"bucket_scan_rows: bad shapes rows "
                         f"{tuple(rows.shape)}, idx {tuple(idx.shape)}, seg "
                         f"{None if seg is None else tuple(seg.shape)}, K={K}, "
                         f"nb={nb} for {group}")
    if rows.device.type == "cpu":
        return bucket_scan_rows_plain(rows, idx, seg, K, group, nb)
    rows, idx = rows.contiguous(), idx.contiguous()
    seg = seg.contiguous() if seg is not None else None
    _cuda_args(rows, idx, *([seg] if seg is not None else []))
    if rows.data_ptr() % 16:
        raise ValueError("bucket_scan_rows: the row table must be 16-byte "
                         "aligned")
    M = n // K
    lanes = B * M
    dev = rows.device
    tails = [torch.empty((R2 // 2, lanes), dtype=torch.int32, device=dev)
             for _ in range(3)]
    buckets = ([torch.zeros((R2 // 2, B * nb), dtype=torch.int32,
                            device=dev) for _ in range(3)]
               if nb is not None else [None] * 3)
    flag = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes:
        _launch("bucket_scan_rows", "zk_bucket_scan_rows", dev,
                _I32(int(group == "g2")), build.ptr(rows), build.ptr(idx),
                build.ptr(seg) if seg is not None else _P(None),
                *(build.ptr(x) for x in tails),
                *(build.ptr(x) if x is not None else _P(None)
                  for x in buckets),
                build.ptr(flag), _I32(K), _I64(lanes), _I64(M),
                _I32(nb or 0))
    return (tuple(tails), tuple(buckets) if nb is not None else None,
            flag != 0)


# ---------------------------------------------------------------------------
# K7  jac_scan
# Replaces jac_scan_pallas (pallas_kernels.py:986; kernel _jac_scan_kernel
# :866, call _jac_scan_call :961).  An inclusive prefix sum of each chunk
# of K Jacobian points with the full group law, restarting where seg
# changes, read in place from the flat (rows, N) layout (element t of
# chunk m at column m*K + t).  A group of g lanes (`jac_scan_group`)
# shares a chunk, L = K/g consecutive points a lane: each lane sums its
# points, a shuffle scan over the g lane totals with the segmented
# operator gives each lane its carry-in, and each lane scans its points
# again from it.  Bound: the chain of dependent full adds per chunk
# (2L - 1 + log2 g; K - 1 at g = 1), on launches too narrow to fill the
# card at one thread per chunk.
# ---------------------------------------------------------------------------

# Warps of a K7 launch up to which its adds do not queue on the card: on
# an H100 a step of the chain took about the same time up to 600 warps
# and about (warps / 600) ** 0.6 times as long beyond (`profile_kernels
# --sweep`, every g at the Groth16 prove's scan shapes; PERF.md).
SCAN_WARPS = 600


def _scan_chain(K: int, g: int) -> int:
    """Dependent full adds of one K7 chunk at g lanes."""
    L = K // g
    return K - 1 if g == 1 else 2 * L - 1 + g.bit_length() - 1


def jac_scan_group(chunks: int, K: int) -> int:
    """Lanes per chunk of K7: the power of two g (dividing K, at most 32)
    with the least chain length x max(1, warps / SCAN_WARPS) ** 0.6.  A
    pure function of the shapes: the wrapper and the plain version both
    call it, so they add in the same order."""
    gs = [1 << i for i in range(6) if K % (1 << i) == 0]
    return min(gs, key=lambda g: _scan_chain(K, g) * max(
        1.0, chunks * g / 32 / SCAN_WARPS) ** 0.6)


def _lane_up(x: torch.Tensor, d: int, g: int) -> torch.Tensor:
    """Per group of g lanes (the last axis), lane i gets lane i - d's value
    (zeros where i < d): the kernel's __shfl_up_sync."""
    xg = x.reshape(x.shape[:-1] + (-1, g))
    out = torch.cat([torch.zeros_like(xg[..., :d]), xg[..., :g - d]], dim=-1)
    return out.reshape(x.shape)


def jac_scan_plain(points, K: int, seg: torch.Tensor = None, g: int = None):
    """The kernel's additions in its order, g lanes per chunk (default
    `jac_scan_group`); at g = 1 the sequential scan of each chunk."""
    o = _OPS[group_of(points[0])]
    n = points[0].shape[-1]
    M = n // K
    g = jac_scan_group(M, K) if g is None else g
    L = K // g
    dev = points[0].device
    p3 = [x.reshape(x.shape[:-1] + (M * g, L)) for x in points]
    restart = torch.zeros(n, dtype=torch.bool, device=dev)
    if seg is not None:
        restart[1:] = seg[1:] != seg[:-1]
    restart[::K] = True                         # each chunk's first point
    restart = restart.reshape(M * g, L)
    lane = torch.arange(M * g, device=dev) % g

    def at(t):
        return tuple(x[..., t] for x in p3)

    def seg_add(acc, t, start):
        """acc + point t, or point t where it restarts."""
        cur = at(t)
        added = _add(start if start is not None else acc, cur, o)
        return tuple(o.sel(restart[:, t], c, a) for c, a in zip(cur, added))

    carry = None
    if g > 1:
        acc = at(0)
        for t in range(1, L):
            acc = seg_add(acc, t, None)
        f = restart.any(dim=1)
        d = 1
        while d < g:
            up = tuple(_lane_up(x, d, g) for x in acc)
            fo = _lane_up(f, d, g)
            added = _add(up, acc, o)
            take = (lane >= d) & ~f
            acc = tuple(o.sel(take, a, x) for a, x in zip(added, acc))
            f = f | ((lane >= d) & fo)
            d *= 2
        carry = tuple(_lane_up(x, 1, g) for x in acc)
    outs = []
    acc = at(0)
    for t in range(L):
        if t or g > 1:
            acc = seg_add(acc, t, carry if t == 0 else None)
        outs.append(acc)
    return tuple(torch.stack([a[i] for a in outs], dim=-1).reshape(
        points[i].shape) for i in range(3))


def jac_scan(points, K: int, seg: torch.Tensor = None, g: int = None):
    """Per-chunk inclusive prefix sums: chunk m is columns [m*K, m*K+K);
    with seg (N,) sorted ids, the sum restarts where seg changes.  g lanes
    per chunk (default `jac_scan_group`; a power of two dividing K, at
    most 32)."""
    n = points[0].shape[-1]
    if K < 1 or n % K:
        raise ValueError(f"jac_scan: width {n} is not a multiple of {K}")
    g = jac_scan_group(n // K, K) if g is None else g
    if g < 1 or g > 32 or g & (g - 1) or K % g:
        raise ValueError(f"jac_scan: {g} lanes per chunk of {K}")
    if points[0].device.type == "cpu":
        return jac_scan_plain(points, K, seg, g)
    ins = [x.contiguous() for x in points]
    _cuda_args(*ins)
    segc = seg.contiguous() if seg is not None else None
    if segc is not None:
        _cuda_args(ins[0], segc)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("jac_scan", "zk_jac_scan", ins[0].device,
                _I32(int(group_of(points[0]) == "g2")),
                *(build.ptr(x) for x in ins),
                build.ptr(segc) if segc is not None else _P(None),
                *(build.ptr(x) for x in outs), _I32(K), _I32(g), _I64(n))
    return tuple(outs)


# ---------------------------------------------------------------------------
# K6  weighted_chunk_sums
# Replaces weighted_chunk_sums (pallas_kernels.py:1455; kernel _wsum_kernel
# :1327, call _wsum_call :1430).  A group of g lanes per chunk (g from
# `wsum_group`): lane i reduces the points i, i+g, ... in registers (a
# reversed scan: S_i, W_i = sum_j j v), then the group combines with
# shuffles, s = sum_i S_i and w = sum_{i>=1} Suf_i + g sum_i W_i (Suf_i =
# sum_{i'>=i} S_i', a suffix scan; g W_i by log2 g doublings).  Bound: the
# chain of dependent full adds per chunk (2L - 3 + 2 log2 g, L = K/g), on
# launches too narrow to fill the card at one thread per chunk.
# ---------------------------------------------------------------------------

# Warps of a K6 launch up to which its adds do not queue on the card: on
# an H100 a step of the chain took the same time at 80 to about 400 warps
# and about (warps / 400) ** 0.75 times as long beyond (`profile_kernels
# --sweep`, every g at the provers' level shapes; PERF.md).
WSUM_WARPS = 400


def _wsum_chain(K: int, g: int) -> float:
    """Dependent full adds of one K6 chunk at g lanes (a doubling counts
    0.45 of an add): the lane's reversed scan, two suffix scans, and the
    doublings and add of g W_i (none for L = 1)."""
    L, lg = K // g, g.bit_length() - 1
    return 2 * lg + (2 * L - 3 + 0.45 * lg + 1 if L > 1 else 0)


def wsum_group(chunks: int, K: int) -> int:
    """Lanes per chunk of K6: the power of two g (dividing K, at most 32)
    with the least chain length x max(1, warps / WSUM_WARPS) ** 0.75.  A
    pure function of the shapes: the wrapper and the plain version both
    call it, so they add in the same order."""
    gs = [1 << i for i in range(6) if K % (1 << i) == 0]
    return min(gs, key=lambda g: _wsum_chain(K, g) * max(
        1.0, chunks * g / 32 / WSUM_WARPS) ** 0.75)


def _lane_down(x: torch.Tensor, d: int, g: int) -> torch.Tensor:
    """Per group of g lanes (the last axis), lane i gets lane i + d's value
    (infinity where i + d >= g): the kernel's __shfl_down_sync."""
    xg = x.reshape(x.shape[:-1] + (-1, g))
    out = torch.nn.functional.pad(xg[..., d:], (0, d))
    return out.reshape(x.shape)


def _group_suffix_scan(P, g: int, lane: torch.Tensor, o: FieldOps):
    """Inclusive suffix sums over each group of g lanes (group_suffix_scan
    in csrc/weighted_sums.cu): lane i adds lane i + d for d = 1, 2, ..."""
    d = 1
    while d < g:
        added = _add(P, tuple(_lane_down(x, d, g) for x in P), o)
        keep = lane + d < g
        P = tuple(o.sel(keep, a, p) for a, p in zip(added, P))
        d *= 2
    return P


def weighted_chunk_sums_plain(points, K: int, g: int = None):
    """The kernel's additions in its order, g lanes per chunk (default
    `wsum_group`)."""
    o = _OPS[group_of(points[0])]
    n = points[0].shape[-1]
    M = n // K
    g = wsum_group(M, K) if g is None else g
    L = K // g
    p4 = [x.reshape(x.shape[:-1] + (M, L, g)) for x in points]
    lane = torch.arange(M * g, device=points[0].device) % g

    def lanes(j):
        return tuple(x[..., j, :].reshape(x.shape[:-3] + (M * g,)) for x in p4)

    w = None
    for j in reversed(range(L)):
        v = lanes(j)
        s = v if j == L - 1 else _add(s, v, o)
        if j >= 1:
            w = s if j == L - 1 else _add(w, s, o)
    s = _group_suffix_scan(s, g, lane, o)
    t = tuple(o.sel(lane >= 1, x, torch.zeros_like(x)) for x in s)
    if L > 1:
        for _ in range(g.bit_length() - 1):
            w = _dbl(w, o)
        t = _add(t, w, o)
    t = _group_suffix_scan(t, g, lane, o)
    return (tuple(x[..., ::g].contiguous() for x in s),
            tuple(x[..., ::g].contiguous() for x in t))


def weighted_chunk_sums(points, K: int, g: int = None):
    """Per chunk of K points: (s, w) with s = sum v_t, w = sum t*v_t; g
    lanes per chunk (default `wsum_group`; a power of two dividing K, at
    most 32)."""
    n = points[0].shape[-1]
    if n % K:
        raise ValueError(f"weighted_chunk_sums: width {n} not a multiple of {K}")
    g = wsum_group(n // K, K) if g is None else g
    if g < 1 or g > 32 or g & (g - 1) or K % g:
        raise ValueError(f"weighted_chunk_sums: {g} lanes per chunk of {K}")
    if points[0].device.type == "cpu":
        return weighted_chunk_sums_plain(points, K, g)
    ins = [x.contiguous() for x in points]
    _cuda_args(*ins)
    shape = ins[0].shape[:-1] + (n // K,)
    outs = [torch.empty(shape, dtype=torch.int32, device=ins[0].device)
            for _ in range(6)]
    if n:
        _launch("weighted_chunk_sums", "zk_weighted_chunk_sums",
                ins[0].device, _I32(int(group_of(points[0]) == "g2")),
                *(build.ptr(x) for x in ins), *(build.ptr(x) for x in outs),
                _I32(K), _I32(g), _I64(n))
    return tuple(outs[:3]), tuple(outs[3:])


# ---------------------------------------------------------------------------
# K8  bucket_scan
# Replaces bucket_scan_pallas (pallas_kernels.py:807; kernel
# _seg_scan_kernel :709, call _seg_scan_call :778).  K5's scan on the flat
# layout (element t of chunk m at column m*K + t), seg compared with its
# predecessor in the kernel; G1 blocks stage their columns in shared
# memory where the copies fit (coalesced, not L words apart a lane).  A
# group of g lanes (`bscan_group`) shares a chunk, L = K/g consecutive
# points a lane: each lane sums its points with madds (the doubling case
# resolved), a shuffle scan over the g lane totals with full adds gives
# each lane its carry-in, and each lane scans its points again from it,
# storing every step and raising the flag where the sequential scan
# raises it.  Bound: the chain of dependent madds and adds a chunk (2L - 1
# madds + log2 g adds; K - 1 madds at g = 1) on a narrow launch, the
# throughput of their products (2K - g madds + g log2 g adds a chunk) on
# a wide one.  The products take their operands by value, so the
# formulas' temporaries stay off the stack (PERF.md §6).
# ---------------------------------------------------------------------------

# A full add's time in mixed adds (16 coordinate products against 11).
BSCAN_ADD = 1.5
# Thread-madds the card runs in the time of one dependent madd of a lone
# warp (K8's launch shapes: G1 2 blocks of 128 an SM, G2 3 of 64): beyond
# it a wide launch is bound by throughput and memory, not its chain.  Fitted
# on an H100 to `profile_kernels --sweep`, every g at the path's shapes
# (PERF.md): it picks the fastest g at each of them.
BSCAN_RATE = {"g1": 25000, "g2": 22000}


def _bscan_chain(K: int, g: int) -> float:
    """Dependent steps of one K8 chunk at g lanes, in madds."""
    L = K // g
    return K - 1 if g == 1 else 2 * L - 1 + BSCAN_ADD * (g.bit_length() - 1)


def _bscan_work(K: int, g: int) -> float:
    """Madds one K8 chunk runs at g lanes (every lane of a group runs
    each phase-2 round)."""
    L = K // g
    return K - 1 if g == 1 else g * (2 * L - 1 + BSCAN_ADD * (
        g.bit_length() - 1))


def bscan_group(chunks: int, K: int, group: str) -> int:
    """Lanes per chunk of K8: the power of two g (dividing K, at most 32)
    with the least max(chain, chunks x work / BSCAN_RATE[group]).  A pure
    function of the shapes: the wrapper and the plain version both call
    it, so they add in the same order."""
    gs = [1 << i for i in range(6) if K % (1 << i) == 0]
    return min(gs, key=lambda g: max(
        _bscan_chain(K, g), chunks * _bscan_work(K, g) / BSCAN_RATE[group]))


def bucket_scan_plain(points, seg: torch.Tensor, K: int, group: str,
                      g: int = None):
    """The kernel's additions in its order, g lanes per chunk (default
    `bscan_group`); at g = 1 the sequential scan of each chunk (K5's,
    `_segmented_madds`)."""
    o = _OPS[group]
    n = seg.shape[-1]
    M = n // K
    g = bscan_group(M, K, group) if g is None else g
    L = K // g
    dev = seg.device
    px, py = (x.reshape(x.shape[:-1] + (M * g, L)) for x in points)
    restart = torch.zeros(n, dtype=torch.bool, device=dev)
    restart[1:] = seg[1:] != seg[:-1]
    restart[::K] = True                         # each chunk's first point
    restart = restart.reshape(M * g, L)
    lane = torch.arange(M * g, device=dev) % g

    def at(t):
        return _jac_of_affine(px[..., t], py[..., t], o)

    def madd(acc, t):
        """acc + point t, or point t where it restarts; and the lanes
        whose madd met P == Q."""
        cur = at(t)
        X3, Y3, Z3, same = _madd(acc, cur[:2], o)
        rs = restart[:, t]
        return (tuple(o.sel(rs, c, a) for c, a in zip(cur, (X3, Y3, Z3))),
                same & ~rs)

    acc = None
    if g > 1:
        acc = at(0)
        for t in range(1, L):
            start = acc
            acc, same = madd(acc, t)
            if bool(same.any()):                # the doubling, resolved
                acc = tuple(o.sel(same, d, a)
                            for d, a in zip(_dbl(start, o), acc))
        f = restart.any(dim=1)
        d = 1
        while d < g:
            up = tuple(_lane_up(x, d, g) for x in acc)
            fo = _lane_up(f, d, g)
            added = _add(up, acc, o)
            take = (lane >= d) & ~f
            acc = tuple(o.sel(take, a, x) for a, x in zip(added, acc))
            f = f | ((lane >= d) & fo)
            d *= 2
        acc = tuple(_lane_up(x, 1, g) for x in acc)     # the carry
    flag = torch.zeros(M * g, dtype=torch.bool, device=dev)
    outs = []
    for t in range(L):
        if t == 0 and g == 1:
            acc = at(0)
        else:
            acc, same = madd(acc, t)
            flag |= same
        outs.append(acc)
    return (tuple(torch.stack([a[i] for a in outs], dim=-1).reshape(
        points[0].shape) for i in range(3)),
        flag.reshape(M, g).any(dim=1))


def bucket_scan(points, seg: torch.Tensor, K: int, group: str,
                g: int = None, in_place: bool = False):
    """In-chunk segmented mixed-add scan over sorted affine points.

    points (X, Y): (12, N) for G1, (2, 12, N) for G2, (0, 0) = infinity;
    seg (N,) int32 sorted bucket ids; N % K == 0.  Returns ((X, Y, Z) in
    the same layout, (N/K,) bool): element i holds the inclusive segmented
    prefix sum of chunk i // K up to position i % K; a flagged chunk hit
    the doubling case of the mixed add and holds garbage.  g lanes per
    chunk (default `bscan_group`; a power of two dividing K, at most
    32).  The G1 kernel stages a block's columns in shared memory where
    two blocks' copies fit an SM (K = 32: g >= 4); `in_place` keeps it
    from staging (the same words), to time the two forms side by side."""
    n = seg.shape[-1]
    if (K <= 0 or n % K or seg.shape != (n,)
            or any(x.shape != ((2, 12, n) if group == "g2" else (12, n))
                   for x in points)):
        raise ValueError(f"bucket_scan: bad shapes {points[0].shape}, "
                         f"{points[1].shape}, {seg.shape} for {group}, K={K}")
    g = bscan_group(n // K, K, group) if g is None else g
    if g < 1 or g > 32 or g & (g - 1) or K % g:
        raise ValueError(f"bucket_scan: {g} lanes per chunk of {K}")
    if points[0].device.type == "cpu":
        return bucket_scan_plain(points, seg, K, group, g)
    ins = [x.contiguous() for x in (*points, seg)]
    _cuda_args(*ins)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    flag = torch.empty(n // K, dtype=torch.int32, device=ins[0].device)
    if n:
        _launch("bucket_scan", "zk_bucket_scan", ins[0].device,
                _I32(int(group == "g2")), *(build.ptr(x) for x in ins),
                *(build.ptr(x) for x in outs), build.ptr(flag), _I32(K),
                _I32(g), _I64(n), _I32(int(in_place)))
    return tuple(outs), flag != 0
