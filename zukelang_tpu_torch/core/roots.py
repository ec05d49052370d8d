"""Generic roots of unity for any prime field — `Curve.Root_of_unity(F)`
(src/lib/zk/curve.ml:241-298).  The port's own copy of
`zukelang_tpu/core/roots.py`.

Decomposes #F - 1 = 2^n * a (a odd), searches for the smallest g whose
g^a is a primitive 2^n-th root of unity, and maps machine uints into F as
powers of that root — the embedding behind the DSL's uint32 type
(uint x |-> omega^x so that uint add becomes field multiplication,
lang.ml:7-21).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple


@functools.lru_cache(maxsize=16)
def two_adic_root(order: int) -> Tuple[int, int]:
    """(n, g_a): 2-adicity n of order-1 and a primitive 2^n-th root g^a.

    Mirrors the search at curve.ml:280-288: try g = 1, 2, 3, ... until
    (g^a)^(2^(n-1)) != 1.
    """
    x = order - 1
    n = 0
    while x % 2 == 0:
        x //= 2
        n += 1
    a = x
    assert n > 0
    g = 1
    while True:
        ga = pow(g, a, order)
        assert pow(ga, 1 << n, order) == 1
        if pow(ga, 1 << (n - 1), order) != 1:
            return n, ga
        g += 1


def f_of_uint(order: int, bits: int, x: int) -> Optional[int]:
    """uint -> field embedding (curve.ml:291-297): omega^(x << (n - bits)),
    None if the field's 2-adicity cannot host `bits`-wide uints."""
    n, ga = two_adic_root(order)
    if bits > n:
        return None
    return pow(ga, x << (n - bits), order)


def uint_of_f(order: int, bits: int, y: int) -> Optional[int]:
    """Inverse of f_of_uint: recover x < 2^bits from y = omega^(x<<(n-bits))
    by Pohlig-Hellman on the 2^n torsion (bit-by-bit: (y*omega^-x)^(2^(n-1-i))
    is 1 or -1).  Returns None when y is not a valid uint embedding —
    witness generation for a range-checked uint32 then fails."""
    n, ga = two_adic_root(order)
    if bits > n:
        return None
    omega = pow(ga, 1 << (n - bits), order)  # primitive 2^bits-th root
    omega_inv = pow(omega, -1, order)
    x = 0
    for i in range(bits):
        t = (y * pow(omega_inv, x, order)) % order
        e = pow(t, 1 << (bits - 1 - i), order)
        if e != 1:
            x |= 1 << i
    # verify (y may not lie in the 2^bits torsion at all)
    if pow(omega, x, order) != y % order:
        return None
    return x
