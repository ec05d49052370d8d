"""Radix-2 NTT over Fr on the 2^32-torsion domain.

Counterpart of `zukelang_tpu/ops/ntt.py`, which is XLA code (a `fori_loop`
of gather butterflies), not a Pallas kernel.  Here it is a Python loop
over the log2(N) stages: torch gathers for the butterfly operands, K1 for
the twiddle products, plain field add/sub for the butterflies.  Twiddles,
coset powers and the bit reversal are built on the host and cached per
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params
from ..params import FR
from . import field as F


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
    """(nl, N/2) Montgomery twiddles w^0 .. w^(N/2 - 1)."""
    n = 1 << logn
    return F._as_tensor(_mont_powers(root_for(logn, inverse), max(1, n // 2)),
                        device)


@functools.lru_cache(maxsize=None)
def _bitrev(logn: int, device) -> torch.Tensor:
    idx = np.arange(1 << logn)
    rev = np.zeros(1 << logn, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return torch.from_numpy(rev).to(device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 NTT along axis 1 of a Montgomery-form (nl, N) Fr tensor.
    Forward maps coefficients to evaluations at w^0 .. w^(N-1); inverse
    maps back, including the 1/N scaling."""
    nl, n = x.shape
    assert nl == FR.nl and n & (n - 1) == 0
    if n == 1:
        return x
    logn = n.bit_length() - 1
    dev = x.device
    tw = _twiddles(logn, inverse, dev)
    x = x[:, _bitrev(logn, dev)]
    j = torch.arange(n // 2, device=dev)
    for s in range(logn):
        half = 1 << s
        pos = j & (half - 1)
        iu = (j >> s) * (2 * half) + pos
        iv = iu + half
        w = tw[:, pos << (logn - 1 - s)]
        u = x[:, iu]
        v = F.mont_mul(x[:, iv], w, FR)
        x[:, iu] = F.add(u, v, FR)
        x[:, iv] = F.sub(u, v, FR)
    if inverse:
        x = F.mont_mul(x, F.const_mont(pow(n, -1, params.R), n, FR, dev),
                       FR)
    return x


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)


# ---------------------------------------------------------------------------
# Coset evaluation: h = (a*b - c) / Z on the coset g*<w>, where Z = x^N - 1
# vanishes on the domain itself.
# ---------------------------------------------------------------------------

_COSET_G = params.FR_GENERATOR


@functools.lru_cache(maxsize=None)
def _coset_powers(logn: int, inverse: bool, device) -> torch.Tensor:
    g = pow(_COSET_G, -1, params.R) if inverse else _COSET_G
    return F._as_tensor(_mont_powers(g, 1 << logn), device)


def coset_ntt(x: torch.Tensor) -> torch.Tensor:
    """Evaluate coefficients on the coset g*<w>: scale by g^i, then NTT."""
    logn = x.shape[1].bit_length() - 1
    return ntt(F.mont_mul(x, _coset_powers(logn, False, x.device), FR))


def coset_intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse of coset_ntt."""
    logn = x.shape[1].bit_length() - 1
    return F.mont_mul(intt(x), _coset_powers(logn, True, x.device), FR)


def zh_on_coset_inv(logn: int) -> int:
    """1 / Z(g*w^i) for Z = x^N - 1: the constant g^N - 1 on the coset."""
    z = (pow(_COSET_G, 1 << logn, params.R) - 1) % params.R
    return pow(z, -1, params.R)
