"""Device pipelines of the prover and of keygen's evaluation at tau.

Counterpart of the device pipelines in `zukelang_tpu/engine/jax_engine.py`
(`_gate_eval` :167, `witness_reduction_fn` / `run_witness_reduction`
:180-224, `_lagrange_at` :239, `_segment_field_sum` and the transpose
matvec :258-288).  The `Engine` class (`TorchEngine`) is later work.

  * witness reduction (prove side): per-gate evaluation as a dense padded
    matvec -> iNTT -> coset pointwise ops -> h coefficients, in three
    transforms of the NTT kernel with the pointwise steps fused;
  * evaluation at tau (keygen side): Lagrange values L_g(tau) over the
    radix-2 domain, then a var-sorted transpose matvec via a segmented
    log-depth scan.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import params
from ..core import flat as flat_mod
from ..ops import field as F
from ..ops import ntt as ntt_mod
from ..params import FR


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
