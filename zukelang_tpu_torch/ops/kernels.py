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
from typing import Dict, Tuple

import torch

from .. import build
from ..params import FQ, FR, FieldSpec
from . import field as F

KERNELS = ("mont_mul", "point_add", "point_double", "point_madd",
           "digit_sort", "bucket_scan_rows", "jac_scan", "weighted_chunk_sums")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_ARGTYPES = {
    "zk_mont_mul": [_I32, _P, _P, _P, _I64, _P],
    "zk_point_add": [_I32] + [_P] * 9 + [_I64, _P],
    "zk_point_double": [_I32] + [_P] * 6 + [_I64, _P],
    "zk_point_madd": [_I32] + [_P] * 9 + [_I64, _P],
    "zk_digit_sort": [_P, _P, _P, _I64, _I64, _I32, _P],
    "zk_bucket_scan_rows": [_I32, _P, _P, _P, _P, _P, _P, _P, _I32, _I64,
                            _I32, _P],
    "zk_jac_scan": [_I32, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _P],
    "zk_weighted_chunk_sums": [_I32] + [_P] * 9 + [_I32, _I64, _P],
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


def _dbl(P, o: FieldOps):
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
        dX, dY, dZ = _dbl(P, o)
        X3, Y3, Z3 = o.sel(same, dX, X3), o.sel(same, dY, Y3), o.sel(same, dZ, Z3)
    X3 = o.sel(q_inf, X1, o.sel(p_inf, X2, X3))
    Y3 = o.sel(q_inf, Y1, o.sel(p_inf, Y2, Y3))
    Z3 = o.sel(q_inf, Z1, o.sel(p_inf, Z2, Z3))
    return X3, Y3, Z3


def _madd(P, Q, o: FieldOps):
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
    shape = a.shape
    a2 = a.reshape(spec.nl, -1).contiguous()
    b2 = b.reshape(spec.nl, -1).contiguous()
    _cuda_args(a2, b2)
    if a2.shape != b2.shape:
        raise ValueError(f"mont_mul shapes differ: {a.shape} vs {b.shape}")
    out = torch.empty_like(a2)
    n = a2.shape[1]
    if n:
        _launch("mont_mul", "zk_mont_mul", a.device,
                _I32(0 if spec is FR else 1), build.ptr(a2), build.ptr(b2),
                build.ptr(out), _I64(n))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# K2  point_add / point_double
# Replaces point_add_pallas / point_double_pallas (pallas_kernels.py:346,
# :359) and their G2 forms (:529, :541).  One thread per element; the whole
# group law runs in registers (spilling to local memory for G2).  Bound:
# the ~16 (add) / ~6 (double) field products per element; launches are
# small (the window combine, tails), so occupancy matters less than
# correctness of every special case.
# ---------------------------------------------------------------------------

def point_add_plain(p, q):
    return _add(p, q, _OPS[group_of(p[0])])


def point_double_plain(p):
    return _dbl(p, _OPS[group_of(p[0])])


def point_add(p, q):
    if p[0].device.type == "cpu":
        return point_add_plain(p, q)
    g2 = group_of(p[0]) == "g2"
    ins = [x.contiguous() for x in (*p, *q)]
    _cuda_args(*ins)
    n = ins[0].shape[-1]
    if any(x.shape != ins[0].shape for x in ins):
        raise ValueError("point_add coordinate shapes differ")
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("point_add", "zk_point_add", ins[0].device, _I32(int(g2)),
                *(build.ptr(x) for x in ins), *(build.ptr(x) for x in outs),
                _I64(n))
    return tuple(outs)


def point_double(p):
    if p[0].device.type == "cpu":
        return point_double_plain(p)
    g2 = group_of(p[0]) == "g2"
    ins = [x.contiguous() for x in p]
    _cuda_args(*ins)
    n = ins[0].shape[-1]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("point_double", "zk_point_double", ins[0].device,
                _I32(int(g2)), *(build.ptr(x) for x in ins),
                *(build.ptr(x) for x in outs), _I64(n))
    return tuple(outs)


# ---------------------------------------------------------------------------
# K3  point_madd
# Replaces point_madd_pallas / point_madd_pallas_g2 (pallas_kernels.py:663,
# :680; kernels _point_madd_kernel / _point_madd_kernel2 :594, :615).  One
# thread per element runs madd-2007-bl (11 field products) in registers,
# as K2 does.  Bound: the field products; the batches on its path are
# small (fixed-base keygen batches under 128 elements, one launch per
# window), so each launch is mostly launch latency.  The flag marks the
# doubling-degenerate lanes (P == Q, both finite), whose output is the
# formula's garbage exactly as in the Pallas kernel; `ops.curve.point_madd`
# repairs them with K2's doubling.
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
    ins = [x.contiguous() for x in (*p, *q)]
    _cuda_args(*ins)
    n = ins[0].shape[-1]
    if any(x.shape != ins[0].shape for x in ins):
        raise ValueError("point_madd coordinate shapes differ")
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    flag = torch.empty(n, dtype=torch.int32, device=ins[0].device)
    if n:
        _launch("point_madd", "zk_point_madd", ins[0].device, _I32(int(g2)),
                *(build.ptr(x) for x in ins), *(build.ptr(x) for x in outs),
                build.ptr(flag), _I64(n))
    return tuple(outs), flag != 0


# ---------------------------------------------------------------------------
# K4  digit_sort
# Replaces bitonic_argsort / bitonic_sort_pairs (pallas_kernels.py:1173,
# :1139; kernel _bitonic_kernel :1083, cross passes :1125).  A per-row
# counting sort over keys in [0, nkeys): one block per row builds the
# histogram with shared-memory atomics, scans it, and one warp scatters the
# row in order with __match_any_sync ranks, so the sort is stable and
# deterministic.  Bound: the single scattering warp's latency per 32 keys;
# rows (windows) run on separate SMs.  Returns (sorted keys, order).
# ---------------------------------------------------------------------------

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
    if nkeys * 4 > 220 * 1024:
        raise ValueError(f"digit_sort: {nkeys} keys exceed shared memory")
    sk = torch.empty_like(k)
    order = torch.empty_like(k)
    if rows and n:
        _launch("digit_sort", "zk_digit_sort", k.device, build.ptr(k),
                build.ptr(sk), build.ptr(order), _I64(rows), _I64(n),
                _I32(nkeys))
    return sk, order


# ---------------------------------------------------------------------------
# K5  bucket_scan_rows
# Replaces bucket_scan_rows (pallas_kernels.py:1296; kernel
# _seg_scan_kernel2 :1192, call _seg_scan2_call :1253).  One thread per
# chunk lane m; the loop over the K points of the chunk keeps the
# accumulator and the collision flag in registers, in place of the Pallas
# grid's sequential t axis.  Bound: 11 field products per point and the
# (K, 2 rows, M) input stream, read coalesced along m.  tails_only writes
# only each lane's final accumulator.
# ---------------------------------------------------------------------------

def bucket_scan_rows_plain(pts3, seg3, segp3, group: str,
                           tails_only: bool = False):
    o = _OPS[group]
    K, R2, M = pts3.shape
    R = R2 // 2

    def coord(x):
        return x.reshape(2, R // 2, M) if group == "g2" else x

    outs = []
    flag = torch.zeros(M, dtype=torch.bool, device=pts3.device)
    acc = None
    for t in range(K):
        CX, CY = coord(pts3[t, :R]), coord(pts3[t, R:])
        cinf = o.is_zero(CX) & o.is_zero(CY)
        CZ = o.sel(cinf, torch.zeros_like(CX), o.one(CX))
        if t == 0:
            acc = (CX, CY, CZ)
        else:
            same_seg = seg3[t, 0] == segp3[t, 0]
            X3, Y3, Z3, col = _madd(acc, (CX, CY), o)
            acc = (o.sel(same_seg, X3, CX), o.sel(same_seg, Y3, CY),
                   o.sel(same_seg, Z3, CZ))
            flag = flag | (col & same_seg)
        if not tails_only:
            outs.append(acc)
    if tails_only:
        outs = [acc]
    res = tuple(torch.stack([a[i].reshape(R, M) for a in outs])
                for i in range(3))
    return res, flag


def bucket_scan_rows(pts3, seg3, segp3, group: str, tails_only: bool = False):
    """pts3 (K, 2 rows, M) stacked [X; Y] affine rows ((0, 0) = infinity),
    seg3/segp3 (K, 1, M) -> ((K or 1, rows, M) X/Y/Z, (M,) bool flags)."""
    if pts3.device.type == "cpu":
        return bucket_scan_rows_plain(pts3, seg3, segp3, group, tails_only)
    pts3, seg3, segp3 = (x.contiguous() for x in (pts3, seg3, segp3))
    _cuda_args(pts3, seg3, segp3)
    K, R2, M = pts3.shape
    if R2 != (96 if group == "g2" else 48) // 2 or seg3.shape != (K, 1, M):
        raise ValueError(f"bucket_scan_rows: bad shapes {pts3.shape}, "
                         f"{seg3.shape} for {group}")
    k_out = 1 if tails_only else K
    outs = [torch.empty((k_out, R2 // 2, M), dtype=torch.int32,
                        device=pts3.device) for _ in range(3)]
    flag = torch.empty(M, dtype=torch.int32, device=pts3.device)
    if M:
        _launch("bucket_scan_rows", "zk_bucket_scan_rows", pts3.device,
                _I32(int(group == "g2")), build.ptr(pts3), build.ptr(seg3),
                build.ptr(segp3), *(build.ptr(x) for x in outs),
                build.ptr(flag), _I32(K), _I64(M), _I32(int(tails_only)))
    return tuple(outs), flag != 0


# ---------------------------------------------------------------------------
# K7  jac_scan
# Replaces jac_scan_pallas (pallas_kernels.py:986; kernel _jac_scan_kernel
# :866, call _jac_scan_call :961).  One thread per chunk: an inclusive
# prefix sum of the chunk's K Jacobian points with the full group law,
# restarting where seg changes.  Bound: ~22 field products per point, in
# registers with spills for G2; the chunk is read in place from the flat
# (rows, N) layout (element t of chunk m at column m*K + t).
# ---------------------------------------------------------------------------

def jac_scan_plain(points, K: int, seg: torch.Tensor = None):
    o = _OPS[group_of(points[0])]
    n = points[0].shape[-1]
    M = n // K
    p2 = [x.reshape(x.shape[:-1] + (M, K)) for x in points]
    s2 = seg.reshape(M, K) if seg is not None else None
    outs = []
    acc = None
    for t in range(K):
        cur = tuple(x[..., t] for x in p2)
        if t == 0:
            acc = cur
        else:
            a = _add(acc, cur, o)
            if s2 is None:
                acc = a
            else:
                cont = s2[:, t] == s2[:, t - 1]
                acc = tuple(o.sel(cont, x, c) for x, c in zip(a, cur))
        outs.append(acc)
    return tuple(torch.stack([a[i] for a in outs], dim=-1).reshape(
        points[i].shape) for i in range(3))


def jac_scan(points, K: int, seg: torch.Tensor = None):
    """Per-chunk inclusive prefix sums: chunk m is columns [m*K, m*K+K)."""
    n = points[0].shape[-1]
    if n % K:
        raise ValueError(f"jac_scan: width {n} is not a multiple of {K}")
    if points[0].device.type == "cpu":
        return jac_scan_plain(points, K, seg)
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
                *(build.ptr(x) for x in outs), _I32(K), _I64(n))
    return tuple(outs)


# ---------------------------------------------------------------------------
# K6  weighted_chunk_sums
# Replaces weighted_chunk_sums (pallas_kernels.py:1455; kernel _wsum_kernel
# :1327, call _wsum_call :1430).  One thread per chunk walks it backwards:
# s = running suffix sum, w += s after each element but the last, so
# s = sum v_t and w = sum t*v_t.  Bound: two full adds per point and two
# Jacobian accumulators in flight (144 words for G2: spills to local
# memory, hence 128-thread blocks).
# ---------------------------------------------------------------------------

def weighted_chunk_sums_plain(points, K: int):
    o = _OPS[group_of(points[0])]
    n = points[0].shape[-1]
    M = n // K
    p2 = [x.reshape(x.shape[:-1] + (M, K)) for x in points]
    s = w = None
    for t in range(K):
        v = tuple(x[..., K - 1 - t] for x in p2)
        s = v if t == 0 else _add(s, v, o)
        if t == 0:
            w = s if K > 1 else tuple(torch.zeros_like(x) for x in s)
        elif t < K - 1:
            w = _add(w, s, o)
    return tuple(x.contiguous() for x in s), tuple(x.contiguous() for x in w)


def weighted_chunk_sums(points, K: int):
    """Per chunk of K points: (s, w) with s = sum v_t, w = sum t*v_t."""
    n = points[0].shape[-1]
    if n % K:
        raise ValueError(f"weighted_chunk_sums: width {n} not a multiple of {K}")
    if points[0].device.type == "cpu":
        return weighted_chunk_sums_plain(points, K)
    ins = [x.contiguous() for x in points]
    _cuda_args(*ins)
    shape = ins[0].shape[:-1] + (n // K,)
    outs = [torch.empty(shape, dtype=torch.int32, device=ins[0].device)
            for _ in range(6)]
    if n:
        _launch("weighted_chunk_sums", "zk_weighted_chunk_sums",
                ins[0].device, _I32(int(group_of(points[0]) == "g2")),
                *(build.ptr(x) for x in ins), *(build.ptr(x) for x in outs),
                _I32(K), _I64(n))
    return tuple(outs[:3]), tuple(outs[3:])
