"""Radix-2 NTT over Fr on the 2^32-torsion domain.

Counterpart of `zukelang_tpu/ops/ntt.py`, which is XLA code (a `fori_loop`
of gather butterflies, K1 for the twiddle products).  Here the transform
is the NTT kernel `csrc/ntt.cu` (`LAUNCHES["ntt"]`), which runs K1's
product as a device function: a few launches a transform, each pass
running up to LOG_TILE stages on tiles kept in shared memory, with the
pointwise steps of the witness reduction fused into its first load and
last store (`transform`; the source note of `csrc/ntt.cu` has the design).
`transform_plain` is its plain version: the same passes, index arithmetic
and fused steps in torch ops, one pass of every stage by default, or the
kernel's split with `log_tile` (the CPU tests run the split at small N).
Twiddles, coset powers and the bit reversal are built on the host and
cached per device.

The stand-alone forms (`ntt`, `intt`, `coset_ntt`, `coset_intt`) take
an (nl, N) or a batch (B, nl, N) of Montgomery-form vectors in natural
order; on the CPU they run the plain version, on the card the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import params, util
from ..params import FR
from . import field as F
from . import kernels

LOG_TILE = 11          # points a block keeps: kNttLogTile in csrc/ntt.cu
PRE_LOAD, PRE_GATE, PRE_QUOT = 0, 1, 2   # the first load (NttPre)


@functools.lru_cache(maxsize=None)
def root_for(logn: int, inverse: bool = False) -> int:
    """Primitive 2^logn-th root of unity in Fr."""
    assert 0 <= logn <= params.FR_TWO_ADICITY
    w = pow(params.FR_ROOT_OF_UNITY,
            1 << (params.FR_TWO_ADICITY - logn), params.R)
    return pow(w, -1, params.R) if inverse else w


def _mont_powers(base: int, count: int) -> np.ndarray:
    """(nl, count) uint32 Montgomery limbs of base^0 .. base^(count-1)."""
    r = params.R
    vals, acc = [], 1
    for _ in range(count):
        vals.append(acc * FR.R % r)
        acc = acc * base % r
    return F._np_limbs(vals, FR.nl)


@functools.lru_cache(maxsize=None)
def _twiddles(logn: int, inverse: bool, device) -> torch.Tensor:
    """(nl, N/2) Montgomery twiddles w^0 .. w^(N/2 - 1), built on the
    host once a shape (span `zk.ntt.twiddles`)."""
    n = 1 << logn
    with util.stage("zk.ntt.twiddles", logn=logn, inverse=inverse):
        return F._as_tensor(_mont_powers(root_for(logn, inverse),
                                         max(1, n // 2)), device)


@functools.lru_cache(maxsize=None)
def _bitrev(logn: int, device) -> torch.Tensor:
    idx = np.arange(1 << logn)
    rev = np.zeros(1 << logn, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return torch.from_numpy(rev).to(device)


# ---------------------------------------------------------------------------
# Coset evaluation: h = (a*b - c) / Z on the coset g*<w>, where Z = x^N - 1
# vanishes on the domain itself.
# ---------------------------------------------------------------------------

_COSET_G = params.FR_GENERATOR


@functools.lru_cache(maxsize=None)
def _coset_powers(logn: int, inverse: bool, device) -> torch.Tensor:
    g = pow(_COSET_G, -1, params.R) if inverse else _COSET_G
    return F._as_tensor(_mont_powers(g, 1 << logn), device)


def zh_on_coset_inv(logn: int) -> int:
    """1 / Z(g*w^i) for Z = x^N - 1: the constant g^N - 1 on the coset."""
    z = (pow(_COSET_G, 1 << logn, params.R) - 1) % params.R
    return pow(z, -1, params.R)


# ---------------------------------------------------------------------------
# One transform: the kernel's passes with its fused first load and last store
# ---------------------------------------------------------------------------

def passes(logn: int,
           log_tile: Optional[int] = None) -> Tuple[Tuple[int, int], ...]:
    """(s0, ns) of each pass of a 2^logn transform at tiles of 2^log_tile
    points (None: one pass of every stage): the stages s0 .. s0 + ns - 1,
    in the DIT's order (a DIF runs them backwards)."""
    t = logn if log_tile is None else min(logn, log_tile)
    if t == 0:
        return ((0, 0),)
    return tuple((s0, min(t, logn - s0)) for s0 in range(0, logn, t))


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain Fr product, b broadcast to a's shape."""
    return kernels.mont_mul_plain(a, b.expand(a.shape).contiguous(), FR)


def gate_sums(side, w: torch.Tensor, rows: torch.Tensor = None,
              mul=None) -> torch.Tensor:
    """Ragged rows (offsets (G+1), cols (nnz), coef (nl, nnz): int32)
    + (nl, V+1) witness -> (nl, len(rows)) row sums, each row's terms
    multiplied (`mul`, default the plain Fr product) and added in term
    order from zero (`_gate_eval` of the JAX engine, which adds zeros for
    its padding); rows None: every row."""
    off, cols, coef = side
    if rows is None:
        rows = torch.arange(off.shape[0] - 1, device=off.device)
    mul = mul or (lambda a, b: kernels.mont_mul_plain(a, b, FR))
    off = off.long()
    start, count = off[rows], off[rows + 1] - off[rows]
    acc = torch.zeros((FR.nl, rows.shape[0]), dtype=torch.int32,
                      device=w.device)
    for k in range(int(count.max()) if rows.numel() else 0):
        live = torch.nonzero(count > k).reshape(-1)
        t = start[live] + k
        term = mul(w[:, cols[t].long()], coef[:, t])
        acc[:, live] = F.add(acc[:, live], term, FR)
    return acc


def _pass_plain(v: torch.Tensor, tw: torch.Tensor, logn: int, s0: int,
                ns: int, log_t: int, dif: bool) -> torch.Tensor:
    """One pass of the kernel on v (nl, B, N): every block's tile gathered
    by the kernel's index arithmetic, its stages, the tiles put back."""
    dev = v.device
    T, log_c = 1 << log_t, log_t - ns
    C = 1 << log_c
    q0 = torch.arange((1 << logn) >> log_t, device=dev)[:, None] * C

    def index(k, cc):                          # (blocks, len(k))
        q = q0 + cc
        return ((q & ((1 << s0) - 1)) + (k << s0)
                + ((q >> s0) << (s0 + ns)))

    e = torch.arange(T, device=dev)
    gi = index(e >> log_c, e & (C - 1))
    tile = v[:, :, gi]                         # (nl, B, blocks, T)
    j = torch.arange(T // 2, device=dev)
    cc, kk = j & (C - 1), j >> log_c
    for t in range(ns):
        sp = ns - 1 - t if dif else t
        s = s0 + sp
        half = 1 << sp
        k = ((kk >> sp) << (sp + 1)) | (kk & (half - 1))
        e1 = (k << log_c) | cc
        e2 = e1 + (half << log_c)
        twi = (index(k, cc) & ((1 << s) - 1)) << (logn - 1 - s)
        w = tw[:, twi].unsqueeze(1)            # (nl, 1, blocks, T/2)
        u, x = tile[..., e1], tile[..., e2]
        if dif:
            d = F.sub(u, x, FR)
            u, x = F.add(u, x, FR), _mul(d, w)
        else:
            x = _mul(x, w)
            u, x = F.add(u, x, FR), F.sub(u, x, FR)
        tile[..., e1] = u
        tile[..., e2] = x
    out = torch.empty_like(v)
    out[:, :, gi] = tile
    return out


def transform_plain(x: Optional[torch.Tensor], logn: int, *, inverse: bool,
                    dif: bool, pre: int = PRE_LOAD, gate=None,
                    zinv: int = None,
                    brev_in: bool = False, brev_out: bool = False,
                    coset_in: bool = False, scale_out: bool = False,
                    coset_out: bool = False,
                    log_tile: Optional[int] = None) -> torch.Tensor:
    """The plain version of `transform`, in its order: the first load at
    the source index, the passes (at tiles of 2^log_tile points; None: one
    pass), the last store."""
    n = 1 << logn
    if pre == PRE_GATE:
        sides, w = gate
        dev = w.device
        v = torch.stack([torch.nn.functional.pad(
            gate_sums(side, w), (0, n - side[0].shape[0] + 1))
            for side in sides])
    elif pre == PRE_QUOT:
        dev = x.device
        v = _mul(F.sub(_mul(x[0], x[1]), x[2], FR),
                 F.const_mont(zinv, 1, FR, dev))[None]
    else:
        dev = x.device
        v = x
    v = v.transpose(0, 1)                      # (nl, B, N)
    if brev_in:
        v = v[..., _bitrev(logn, dev)]
    if coset_in:
        v = _mul(v, _coset_powers(logn, False, dev)[:, None, :])
    tw = _twiddles(logn, inverse, dev)
    plan = passes(logn, log_tile)
    log_t = plan[0][1]
    for s0, ns in (reversed(plan) if dif else plan):
        v = _pass_plain(v, tw, logn, s0, ns, log_t, dif)
    if scale_out:
        v = _mul(v, F.const_mont(pow(n, -1, params.R), 1, FR, dev)[:, None])
    if coset_out:
        v = _mul(v, _coset_powers(logn, True, dev)[:, None, :])
    if brev_out:
        v = v[..., _bitrev(logn, dev)]
    return v.transpose(0, 1).contiguous()


class _NttArgs(ctypes.Structure):
    """`NttArgs` of csrc/ntt.cu, field by field."""
    _fields_ = [
        ("in_", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("tw", ctypes.c_void_p), ("pre_tab", ctypes.c_void_p),
        ("post_tab", ctypes.c_void_p),
        ("gate_off", ctypes.c_void_p * 3), ("gate_idx", ctypes.c_void_p * 3),
        ("gate_coef", ctypes.c_void_p * 3), ("w", ctypes.c_void_p),
        ("gate_nnz", ctypes.c_int64 * 3),
        ("n_gates", ctypes.c_int64), ("w_cols", ctypes.c_int64),
        ("zinv", ctypes.c_uint32 * 8), ("post_c", ctypes.c_uint32 * 8),
        ("logn", ctypes.c_int32), ("batch", ctypes.c_int32),
        ("dif", ctypes.c_int32), ("pre", ctypes.c_int32),
        ("brev_in", ctypes.c_int32), ("brev_out", ctypes.c_int32),
        ("post_const", ctypes.c_int32), ("unused", ctypes.c_int32)]


def _mont_words(x: int):
    """Montgomery limbs of x as a C uint32[8]."""
    return (ctypes.c_uint32 * 8)(*params.int_to_limbs(x * FR.R % FR.p, FR.nl))


def _transform_kernel(x, logn, *, inverse, dif, pre, gate, zinv, brev_in,
                      brev_out, coset_in, scale_out, coset_out):
    n = 1 << logn
    a = _NttArgs()
    a.logn, a.dif, a.pre = logn, int(dif), pre
    a.brev_in, a.brev_out = int(brev_in), int(brev_out)
    if pre == PRE_GATE:
        sides, w = gate
        w = w.contiguous()
        sides = [tuple(t.contiguous() for t in s) for s in sides]
        kernels._cuda_args(w, *(t for s in sides for t in s))
        a.batch, a.n_gates, a.w_cols = 3, sides[0][0].shape[0] - 1, w.shape[1]
        if a.n_gates > n or any(
                off.shape != (a.n_gates + 1,) or i.dim() != 1
                or c.shape != (FR.nl,) + i.shape for off, i, c in sides):
            raise ValueError(f"ntt: gate sides of {a.n_gates} gates do not "
                             f"fit a 2^{logn} domain")
        for b, (off, i, c) in enumerate(sides):
            a.gate_off[b], a.gate_idx[b] = off.data_ptr(), i.data_ptr()
            a.gate_coef[b], a.gate_nnz[b] = c.data_ptr(), i.shape[0]
        a.w = w.data_ptr()
        dev = w.device
    else:
        x = x.contiguous()
        kernels._cuda_args(x)
        dev = x.device
        if x.shape[1:] != (FR.nl, n) or (pre == PRE_QUOT and x.shape[0] != 3):
            raise ValueError(f"ntt: input {tuple(x.shape)} for 2^{logn}")
        a.batch = 1 if pre == PRE_QUOT else x.shape[0]
        if pre == PRE_QUOT:
            a.zinv = _mont_words(zinv)
    tw = _twiddles(logn, inverse, dev)
    tabs = (_coset_powers(logn, False, dev) if coset_in else None,
            _coset_powers(logn, True, dev) if coset_out else None)
    a.tw = tw.data_ptr()
    a.pre_tab, a.post_tab = (t.data_ptr() if t is not None else None
                             for t in tabs)
    if scale_out:
        a.post_const, a.post_c = 1, _mont_words(pow(n, -1, params.R))
    out = torch.empty((a.batch, FR.nl, n), dtype=torch.int32, device=dev)
    plan = passes(logn, LOG_TILE)
    order = list(reversed(plan)) if dif else list(plan)
    # a pass that permutes its store reads another buffer than it writes
    mid = (torch.empty_like(out) if brev_out and len(order) > 1 else out)
    for p, (s0, ns) in enumerate(order):
        first, last = p == 0, p == len(order) - 1
        a.in_ = (x if first and pre != PRE_GATE else mid).data_ptr()
        a.out = (out if last else mid).data_ptr()
        kernels._launch("ntt", "zk_ntt_pass", dev,
                        ctypes.c_void_p(ctypes.addressof(a)),
                        kernels._I32(s0), kernels._I32(ns),
                        kernels._I32(int(first)), kernels._I32(int(last)))
    return out


def transform(x: Optional[torch.Tensor], logn: int, *, inverse: bool,
              dif: bool, pre: int = PRE_LOAD, gate=None, zinv: int = None,
              brev_in: bool = False, brev_out: bool = False,
              coset_in: bool = False, scale_out: bool = False,
              coset_out: bool = False) -> torch.Tensor:
    """One radix-2 transform of a batch, with its fused steps.

    x (B, nl, N) Montgomery vectors (for pre=PRE_QUOT the three a, b, c
    of one output; None for PRE_GATE).  DIT (dif False) takes bit-reversed
    input to natural output, DIF natural input to bit-reversed output;
    inverse takes the inverse twiddles.  The first load reads the source
    index bitrev(i) with brev_in, else i: PRE_LOAD x[b], PRE_GATE side b
    of gate = (((offsets, cols, coef) of l, r, lhs), witness) summed over
    that gate's own terms (zero past the gates), PRE_QUOT (x[0] x[1] -
    x[2]) zinv; then times g^src with coset_in.  The last store multiplies by 1/N
    (scale_out), then by g^-i (coset_out), and writes output index i at
    bitrev(i) with brev_out.  -> (B, nl, N); B = 3 for PRE_GATE, 1 for
    PRE_QUOT."""
    opts = dict(inverse=inverse, dif=dif, pre=pre, gate=gate, zinv=zinv,
                brev_in=brev_in, brev_out=brev_out, coset_in=coset_in,
                scale_out=scale_out, coset_out=coset_out)
    dev = gate[1].device if pre == PRE_GATE else x.device
    if dev.type == "cpu":
        return transform_plain(x, logn, **opts)
    return _transform_kernel(x, logn, **opts)


# ---------------------------------------------------------------------------
# The stand-alone forms, natural order in and out
# ---------------------------------------------------------------------------

_FORMS = {
    "ntt": dict(inverse=False, dif=True, brev_out=True),
    "intt": dict(inverse=True, dif=False, brev_in=True, scale_out=True),
    "coset_ntt": dict(inverse=False, dif=True, brev_out=True, coset_in=True),
    "coset_intt": dict(inverse=True, dif=False, brev_in=True, scale_out=True,
                       coset_out=True),
}


def _form(x: torch.Tensor, form: str, plain: bool = False,
          log_tile: Optional[int] = None) -> torch.Tensor:
    xb = x[None] if x.dim() == 2 else x
    n = xb.shape[-1]
    if xb.dim() != 3 or xb.shape[1] != FR.nl or n & (n - 1) or n == 0:
        raise ValueError(f"ntt: shape {tuple(x.shape)} is not (nl, N) or "
                         "(B, nl, N) with N a power of two")
    logn = n.bit_length() - 1
    if plain:
        out = transform_plain(xb, logn, log_tile=log_tile, **_FORMS[form])
    else:
        out = transform(xb, logn, **_FORMS[form])
    return out[0] if x.dim() == 2 else out


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 NTT along the last axis of Montgomery-form (nl, N) or
    (B, nl, N) Fr vectors.  Forward maps coefficients to evaluations at
    w^0 .. w^(N-1); inverse maps back, including the 1/N scaling."""
    return _form(x, "intt" if inverse else "ntt")


def intt(x: torch.Tensor) -> torch.Tensor:
    return _form(x, "intt")


def coset_ntt(x: torch.Tensor) -> torch.Tensor:
    """Evaluate coefficients on the coset g*<w>: scale by g^i, then NTT."""
    return _form(x, "coset_ntt")


def coset_intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse of coset_ntt."""
    return _form(x, "coset_intt")


def ntt_plain(x, inverse=False, log_tile=None):
    return _form(x, "intt" if inverse else "ntt", True, log_tile)


def intt_plain(x, log_tile=None):
    return _form(x, "intt", True, log_tile)


def coset_ntt_plain(x, log_tile=None):
    return _form(x, "coset_ntt", True, log_tile)


def coset_intt_plain(x, log_tile=None):
    return _form(x, "coset_intt", True, log_tile)
