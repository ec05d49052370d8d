"""The device engine: NTT-domain QAP algebra, Pippenger MSM and
fixed-base batches on the card, behind the `Engine` seam.

Counterpart of `zukelang_tpu/engine/jax_engine.py`: `TorchEngine` is
`JaxEngine` (:52-149), and the device pipelines below are its back end
and that of the device protocols (`_gate_eval` :167,
`witness_reduction_fn` / `run_witness_reduction` :180-224,
`_lagrange_at` :239, `_segment_field_sum` and the transpose matvec
:258-288).

  * witness reduction (prove side): per-gate evaluation as a dense padded
    matvec -> iNTT -> coset pointwise ops -> h coefficients, in three
    transforms of the NTT kernel with the pointwise steps fused;
  * evaluation at tau (keygen side): Lagrange values L_g(tau) over the
    radix-2 domain, then a var-sorted transpose matvec via a segmented
    log-depth scan;
  * dots, powers and fixed-base batches: `ops/msm.py`, golden points
    packed to limb batches on the host and the results unpacked.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import params
from ..core import flat as flat_mod
from ..core import poly
from ..core.qap import QAP
from ..golden.curve import G1, G2
from ..golden.field import Fr
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..ops import ntt as ntt_mod
from ..params import FR
from .base import Engine, GoldenEngine

# MSM window width; None = size-based auto (`msm.auto_window`).
DEFAULT_MSM_WINDOW = None
# Fixed-base window width of the batches and powers (2^c table entries a
# window): `JaxEngine`'s, the JAX `fixed_base_mul` default.  Its tables
# build in seconds on the plain versions too (c = 16's take many minutes).
DEFAULT_FB_WINDOW = 8


def _reduce(step, logn: int, sides, w: torch.Tensor):
    """The witness reduction as three transforms (the NTT kernel's fused
    sequence, `ops/ntt.py`): the gate sums at bit-reversed gates through
    the inverse DIT -> a, b, c coefficients; the coset scaling through the
    forward DIF -> evaluations in bit-reversed order; (a b - c) / Z_H
    through the inverse DIT, with the coset unscaling -> h.  `step` is
    `ntt.transform` or its plain version."""
    abc = step(None, logn, inverse=True, dif=False, pre=ntt_mod.PRE_GATE,
               gate=(sides, w), brev_in=True, scale_out=True)
    cos = step(abc, logn, inverse=False, dif=True, coset_in=True)
    h = step(cos, logn, inverse=True, dif=False, pre=ntt_mod.PRE_QUOT,
             zinv=ntt_mod.zh_on_coset_inv(logn), scale_out=True,
             coset_out=True)
    return abc[0], abc[1], h[0]


def witness_reduction_plain(logn: int, log_tile: Optional[int] = None):
    """The plain version of `witness_reduction_fn` (`ntt.transform_plain`
    at tiles of 2^log_tile points; None: one pass a transform)."""
    step = functools.partial(ntt_mod.transform_plain, log_tile=log_tile)

    def run(l_idx, l_coef, r_idx, r_coef, o_idx, o_coef, w):
        return _reduce(step, logn, ((l_idx, l_coef), (r_idx, r_coef),
                                    (o_idx, o_coef)), w)

    return run


def witness_reduction_fn(logn: int):
    """The witness-reduction pipeline for one domain size: gate evaluation
    -> iNTT -> coset quotient -> h coefficients.  Returns (a, b, h).  On
    the card it is six launches of the NTT kernel at 2^12 to 2^22 points
    (three at or below 2^11); on the CPU its plain version.  idx: (G, K)
    int32 witness columns; coef: (nl, G, K) Montgomery; w: (nl, V+1)."""

    def run(l_idx, l_coef, r_idx, r_coef, o_idx, o_coef, w):
        return _reduce(ntt_mod.transform, logn, ((l_idx, l_coef),
                                                 (r_idx, r_coef),
                                                 (o_idx, o_coef)), w)

    return run


def _side_tensors(side: flat_mod.FlatSide, device):
    """(idx, coef) of a side on `device`, kept on the side after the first
    call so that a prove copies nothing to the card."""
    key = str(device)
    if key not in side.device_copies:
        side.device_copies[key] = (
            torch.from_numpy(side.idx.astype(np.int32)).to(device),
            F._as_tensor(side.coef, device))
    return side.device_copies[key]


def run_witness_reduction(fc: flat_mod.FlatCircuit, witness_mont: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, b, h) Montgomery coefficient tensors for the witness, on the
    witness's device."""
    dev = witness_mont.device
    args = (*_side_tensors(fc.l, dev), *_side_tensors(fc.r, dev),
            *_side_tensors(fc.lhs, dev))
    return witness_reduction_fn(fc.logn)(*args, witness_mont)


def _lagrange_at(logn: int, x: int, device=None) -> torch.Tensor:
    """(nl, N) Montgomery Lagrange values L_g(x) over the 2^logn domain:
    L_g(x) = (Z(x)/N) * w^g / (x - w^g)."""
    n = 1 << logn
    r = params.R
    omegas = ntt_mod._mont_powers(ntt_mod.root_for(logn), n)
    omegas = F._as_tensor(omegas, device)
    zn = (pow(x, n, r) - 1) * pow(n, -1, r) % r
    diff = F.sub(F.const_mont(x, n, FR, device), omegas, FR)
    num = F.mont_mul(omegas, F.inv(diff, FR), FR)
    return F.mont_mul(num, F.const_mont(zn, n, FR, device), FR)


def _segment_field_sum(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of Fr values along the batch axis (seg
    sorted), log-depth (Hillis-Steele)."""
    n = seg.shape[-1]
    idx = torch.arange(n, device=seg.device)
    x = values
    for d in range(max(1, (n - 1).bit_length())):
        sh = 1 << d
        valid = (idx >= sh) & (seg == torch.roll(seg, sh))
        x = F.select(valid, F.add(x, torch.roll(x, sh, dims=-1), FR), x)
    return x


def transpose_matvec(side: flat_mod.FlatSide, weights: torch.Tensor,
                     n_vars: int) -> torch.Tensor:
    """(nl, n_vars) per-variable sums sum_g coeff(k, g) * weights[g]."""
    dev = weights.device
    t_var = torch.from_numpy(side.t_var.astype(np.int64)).to(dev)
    t_gate = torch.from_numpy(side.t_gate.astype(np.int64)).to(dev)
    prod = F.mont_mul(weights[:, t_gate], F._as_tensor(side.t_coef, dev), FR)
    scanned = _segment_field_sum(prod, t_var)
    is_tail = torch.ones_like(t_var, dtype=torch.bool)
    is_tail[:-1] = t_var[:-1] != t_var[1:]
    out = torch.zeros((FR.nl, n_vars), dtype=torch.int32, device=dev)
    out[:, t_var[is_tail]] = scanned[:, is_tail]
    return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _unpack_fr(t: torch.Tensor) -> List[Fr]:
    return [Fr(v) for v in F.unpack_mont(t, FR)]


def checked_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless `device` names
    another; raises where CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device (pass device='cpu' for the "
                           "kernels' plain versions)")
    return dev


class TorchEngine(Engine):
    """`JaxEngine` on PyTorch tensors: on the card unless `device` names
    another (the tests pass "cpu", which takes each kernel's plain
    version).  `msm_window` pins the MSM window width (None: the module
    default); fixed-base batches and powers take `DEFAULT_FB_WINDOW`.
    `host_s` sums the host seconds spent packing golden points and
    scalars into limb batches and unpacking the results."""

    name = "torch"

    def __init__(self, device=None, msm_window: int = None):
        self.device = checked_device(device)
        self.msm_window = (DEFAULT_MSM_WINDOW if msm_window is None
                           else msm_window)
        self.host_s = 0.0
        self._flat_cache: Dict[int, Tuple[QAP, flat_mod.FlatCircuit]] = {}

    # -- host packing and unpacking, timed ------------------------------------
    def _host(self, fn, *args):
        """fn(*args), its seconds added to `host_s`; the card is
        synchronised first, so that its work is not counted."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        self.host_s += time.perf_counter() - t0
        return out

    def _unpack(self, group: str, p: C.Point, n: int = None) -> list:
        """The first n points of a batch -> golden points."""
        if n is not None:
            p = tuple(x[..., :n] for x in p)
        return self._host(C.unpack_g1 if group == "g1" else C.unpack_g2, p)

    # -- MSM -------------------------------------------------------------------
    def _dot(self, group: str, points, scalars):
        if len(points) != len(scalars):
            raise ValueError("dot: length mismatch")
        n = len(points)
        zero = G1.zero() if group == "g1" else G2.zero()
        if n == 0:
            return zero
        npad = msm_mod.padded_width(n)
        P = self._host(C.pack_affine, list(points) + [zero] * (npad - n),
                       group, self.device)
        S = self._host(F.pack, [s.n for s in scalars] + [0] * (npad - n), FR,
                       self.device)
        res = msm_mod.msm_staged_deferred(P, S, group, self.msm_window)()
        return self._unpack(group, res)[0]

    def g1_dot(self, points, scalars):
        return self._dot("g1", points, scalars)

    def g2_dot(self, points, scalars):
        return self._dot("g2", points, scalars)

    # -- fixed base ------------------------------------------------------------
    def _of_fr_batch(self, group: str, scalars):
        n = len(scalars)
        if n == 0:
            return []
        npad = msm_mod.padded_width(n, msm_mod.FB_MIN_LOG)
        S = self._host(F.pack, [s.n for s in scalars] + [0] * (npad - n), FR,
                       self.device)
        return self._unpack(group, msm_mod.fixed_base_mul(
            S, group=group, c=DEFAULT_FB_WINDOW), n)

    def g1_of_fr_batch(self, scalars):
        return self._of_fr_batch("g1", scalars)

    def g2_of_fr_batch(self, scalars):
        return self._of_fr_batch("g2", scalars)

    def _powers(self, group: str, d: int, s: Fr):
        pts = msm_mod.g_powers(s.n, d, group, self.device,
                                 DEFAULT_FB_WINDOW)
        return self._unpack(group, pts)

    def g1_powers(self, d, s):
        return self._powers("g1", d, s)

    def g2_powers(self, d, s):
        return self._powers("g2", d, s)

    # -- QAP algebra -----------------------------------------------------------
    def _flat(self, qap: QAP) -> flat_mod.FlatCircuit:
        """The QAP's gates flattened once; the entry keeps the QAP alive,
        so its id is not reused while cached."""
        hit = self._flat_cache.get(id(qap))
        if hit is None or hit[0] is not qap:
            hit = (qap, flat_mod.flatten(qap.gates))
            self._flat_cache[id(qap)] = hit
        return hit[1]

    def qap_witness_reduction(self, qap: QAP, sol):
        """-> (A, B, h) coefficient lists, normalised as `GoldenEngine`'s.
        The reference domain has no NTT: there the golden engine computes
        it, as in the JAX package."""
        if qap.domain != "ntt":
            return GoldenEngine().qap_witness_reduction(qap, sol)
        fc = self._flat(qap)
        w = self._host(fc.pack_witness, sol, self.device)
        a, b, h = run_witness_reduction(fc, w)
        return tuple(poly.normalize(self._host(_unpack_fr, x))
                     for x in (a, b, h))

    def qap_eval_at(self, qap: QAP, x: Fr):
        """Every variable's v / w / y polynomial at x: three dicts Var ->
        Fr (Lagrange values at x and a transpose matvec on the device)."""
        if qap.domain != "ntt":
            return GoldenEngine().qap_eval_at(qap, x)
        fc = self._flat(qap)
        lag = _lagrange_at(fc.logn, x.n, self.device)
        nv = len(fc.vars_sorted)
        return tuple(
            dict(zip(fc.vars_sorted,
                     self._host(_unpack_fr, transpose_matvec(side, lag, nv))))
            for side in (fc.l, fc.r, fc.lhs))

    def qap_eval(self, qap, sol):
        # p is not materialised on the device path (`JaxEngine.qap_eval`)
        _a, _b, h = self.qap_witness_reduction(qap, sol)
        return None, h
