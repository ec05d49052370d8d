"""Pairings for the port's protocols.

The native library (`native.py`, the port's copy of the C++ tower) by
default; the golden pure-Python pairing (`golden/pairing.py`) only where
the caller names it, as the tests do for the oracle.  A native library
that cannot be built or loaded raises: nothing switches backends by
itself.
"""

from __future__ import annotations

from . import native
from .golden.pairing import multi_pairing as _golden_multi_pairing
from .golden.curve import GT

BACKENDS = ("native", "golden")


def multi_pairing(pairs, backend: str = "native") -> GT:
    """prod_i e(P_i, Q_i), one shared final exponentiation."""
    pairs = list(pairs)
    if backend == "native":
        return native.gt_multi_pairing(pairs)
    if backend == "golden":
        return _golden_multi_pairing(pairs)
    raise ValueError(f"pairing backend {backend!r}: one of {BACKENDS}")


def pairing(p, q, backend: str = "native") -> GT:
    """e(P, Q) for P in G1, Q in G2."""
    return multi_pairing([(p, q)], backend)
