"""Fast polynomial multiplication — the reference's standalone FFT engine.

The port's own copy of `zukelang_tpu/ops/fft.py`.  Mirrors `FFT.Make`
(src/lib/zk/FFT.ml:29-105): a generic radix-2 transform instantiated for
the complex numbers (sanity/benchmark instance, FFT.ml:111) and for
BLS12-381 Fr (FFT.ml:222-233), with `polynomial_mul` as pointwise
multiplication in the evaluation domain.

The complex instance is `torch.fft` over complex128, as the JAX module's
is `jnp.fft`.  The Fr instance runs the NTT kernel (`ops.ntt.ntt` /
`intt`, `csrc/ntt.cu`) and K1 (`field.mont_mul`) for the pointwise
product, on the card unless `device` names another (the CPU takes the
kernels' plain versions); values cross this API as golden `Fr` lists.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..engine.torch_engine import checked_device
from ..golden.field import Fr
from ..params import FR
from . import field as F
from . import ntt as ntt_mod


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# -- complex instance (FFT.ml:111-129) --------------------------------------

def fft_c(coeffs: Sequence[complex], min_len: int = None,
          device=None) -> np.ndarray:
    n = _next_pow2(max(len(coeffs), min_len or 1))
    a = torch.zeros(n, dtype=torch.complex128, device=checked_device(device))
    if len(coeffs):
        a[: len(coeffs)] = torch.as_tensor(np.asarray(coeffs, np.complex128))
    return torch.fft.fft(a).cpu().numpy()


def ifft_c(values: Sequence[complex], device=None) -> np.ndarray:
    v = torch.as_tensor(np.asarray(values, np.complex128),
                        device=checked_device(device))
    return torch.fft.ifft(v).cpu().numpy()


def polynomial_mul_c(p1: Sequence[complex], p2: Sequence[complex],
                     device=None) -> np.ndarray:
    """FFT.ml:98-105 over the complex field."""
    out_len = len(p1) + len(p2) - 1
    n = _next_pow2(out_len)
    a = fft_c(p1, n, device)
    b = fft_c(p2, n, device)
    return ifft_c(a * b, device)[:out_len]


# -- Fr instance (FFT.ml:222-233) -------------------------------------------

def _pack(values: List[int], n: int, device) -> torch.Tensor:
    """Ints, zero-padded to n, -> (8, n) Montgomery limbs on `device`."""
    return F.pack_mont(list(values) + [0] * (n - len(values)), FR, device)


def _unpack(t: torch.Tensor) -> List[Fr]:
    return [Fr(v) for v in F.unpack_mont(t, FR)]


def fft_fr(coeffs: List[Fr], min_len: int = None, device=None) -> List[Fr]:
    """Evaluate a coefficient list on the radix-2 root-of-unity domain."""
    n = _next_pow2(max(len(coeffs), min_len or 1, 2))
    x = _pack([c.n for c in coeffs], n, checked_device(device))
    return _unpack(ntt_mod.ntt(x))


def ifft_fr(values: List[Fr], device=None) -> List[Fr]:
    n = len(values)
    if n & (n - 1):
        raise ValueError(f"ifft_fr: length {n} is not a power of two")
    x = _pack([v.n for v in values], n, checked_device(device))
    return _unpack(ntt_mod.intt(x))


def polynomial_mul_fr(p1: List[Fr], p2: List[Fr], device=None) -> List[Fr]:
    """NTT-based polynomial multiplication over Fr — the fast path the
    reference benchmarks but never uses (SURVEY.md U5)."""
    if not p1 or not p2:
        return []
    out_len = len(p1) + len(p2) - 1
    n = _next_pow2(out_len)
    dev = checked_device(device)
    ea = ntt_mod.ntt(_pack([c.n for c in p1], n, dev))
    eb = ntt_mod.ntt(_pack([c.n for c in p2], n, dev))
    prod = F.mont_mul(ea, eb, FR)
    return _unpack(ntt_mod.intt(prod))[:out_len]
