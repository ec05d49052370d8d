"""The limb products the MSMs of a prove need: the count behind
`msm_roofline`.

The count is of the work the problem needs, whatever implements it:

  * an MSM of n terms over 255-bit scalars, as a signed-digit Pippenger
    MSM: windows of c bits, ceil(256 / c) windows (255 bits and the carry
    of the signed recoding), 2^(c-1) buckets a window, each term one
    addition into a bucket and each bucket one addition in the window's
    reduction: (n + 2^(c-1)) * ceil(256 / c) additions, at the c that
    makes this least.  No endomorphism, no precomputed multiples; the
    doublings that combine the windows (about 256) are left out.
  * every addition a mixed addition, madd-2007-bl: 7 multiplications and
    4 squarings, 11 products in the coordinate field.  G1 over Fq: 11 Fq
    products; G2 over Fq2: 11 Fq2 products of 3 Fq products each.
  * an Fq product in CIOS Montgomery form over 12 limbs of 32 bits:
    12 x 12 limb products of a b and 12 x 12 of m p, 288; the 12 quotient
    digits (low words only) and every addition of words are left out.
    A limb product is 32 x 32 -> 64 bits: a low and a high multiply-add.

The least time is this count over the card's rate of limb products,
measured in the same run (`zkbench.peak`).  The bytes (each base and
scalar read once) never bind at any size: a term's 128-224 bytes are
read in the time of a few limb products, and each term takes thousands.
Product work on the tensor cores would need another peak and a new
benchmark entry.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

SCALAR_BITS = 255
MADD_PRODUCTS = 11                 # madd-2007-bl: 7M + 4S
FQ2_FQ_PRODUCTS = 3                # Karatsuba
FQ_LIMBS = 12
FQ_LIMB_PRODUCTS = 2 * FQ_LIMBS * FQ_LIMBS           # CIOS: 288
ADD_LIMB_PRODUCTS = {"g1": MADD_PRODUCTS * FQ_LIMB_PRODUCTS,
                     "g2": MADD_PRODUCTS * FQ2_FQ_PRODUCTS * FQ_LIMB_PRODUCTS}


def windows(c: int) -> int:
    return -(-(SCALAR_BITS + 1) // c)


def additions(n: int, c: int) -> int:
    return (n + (1 << (c - 1))) * windows(c)


def best_window(n: int) -> Tuple[int, int]:
    """(c, additions) at the c in 1 .. 32 with the fewest additions."""
    return min(((c, additions(n, c)) for c in range(1, 33)),
               key=lambda t: (t[1], t[0]))


def msm_limb_products(terms: Dict[str, Iterable[int]]) -> int:
    """The limb products of a prove's MSMs: `terms` maps a group ("g1",
    "g2") to the term counts of its MSMs."""
    return sum(best_window(n)[1] * ADD_LIMB_PRODUCTS[group]
               for group, counts in terms.items() for n in counts)
