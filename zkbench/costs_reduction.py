"""The least time of a prove's witness reduction: the count behind
`reduction_roofline`.

The count is of the work the problem needs, whatever implements it:

  * the gate sums: one Fr product a term of the three sides (nnz
    products, each row its own terms; not rows x the widest row);
  * three inverse and three forward transforms of a, b, c and one
    inverse transform of h: 7 transforms of N/2 log2 N butterflies, one
    Fr product each;
  * the quotient: N products a b (the constant 1 / Z(g w^i), the coset
    scalings and 1/N left out);
  * an Fr product in CIOS Montgomery form over 8 limbs of 32 bits:
    8 x 8 limb products of a b and 8 x 8 of m p, 128 (as `zkbench.costs`
    counts an Fq product's);
  * bytes: each term's column and coefficient read once (36 B), the
    witness read once (32 B a column), a, b and h written once (3 N x
    32 B).

The least time is the larger of the limb products over the card's rate
measured in the same run (`zkbench.peak`) and the bytes over 3.35e12 B/s
(NVIDIA's H100 SXM data sheet, 80 GB HBM3).
"""

from __future__ import annotations

FR_LIMBS = 8
FR_LIMB_PRODUCTS = 2 * FR_LIMBS * FR_LIMBS           # CIOS: 128
TRANSFORMS = 7
TERM_BYTES = 4 + 4 * FR_LIMBS                        # column + coefficient
HBM_BYTES_PER_S = 3.35e12                            # data sheet


def products(nnz: int, logn: int) -> int:
    """Fr products of a reduction over nnz terms in a 2^logn domain."""
    n = 1 << logn
    return nnz + TRANSFORMS * (n // 2) * logn + n


def bytes_moved(nnz: int, logn: int, n_vars: int) -> int:
    return TERM_BYTES * nnz + 4 * FR_LIMBS * (n_vars + 3 * (1 << logn))


def least_seconds(shape: dict, limb_products_per_s: float) -> float:
    """shape: `nnz`, `logn` and `vars` of the circuit."""
    nnz, logn = int(shape["nnz"]), int(shape["logn"])
    return max(products(nnz, logn) * FR_LIMB_PRODUCTS / limb_products_per_s,
               bytes_moved(nnz, logn, int(shape["vars"])) / HBM_BYTES_PER_S)
