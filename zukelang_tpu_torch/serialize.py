"""JSON encodings of scalars and points for the keypair files.

The port's own copy of the helpers of `zukelang_tpu/serialize.py` that the
keypair `.npz` needs, so a file written by either package reads back in
the other: Fr as a decimal string, G1/G2 as ZCash compressed bytes in
lowercase hex, GT as its 576 uncompressed bytes in hex.
"""

from __future__ import annotations

from .golden.curve import G1, G2, GT
from .golden.field import Fr


def fr_to_json(f) -> str:
    return str(f.n)


def fr_of_json(j) -> Fr:
    return Fr(int(j))


def g1_to_json(p) -> str:
    return p.to_compressed_bytes().hex()


def g1_of_json(j) -> G1:
    return G1.of_compressed_bytes(bytes.fromhex(j))


def g2_to_json(p) -> str:
    return p.to_compressed_bytes().hex()


def g2_of_json(j) -> G2:
    return G2.of_compressed_bytes(bytes.fromhex(j))


def gt_to_json(p) -> str:
    return p.to_bytes().hex()


def gt_of_json(j) -> GT:
    return GT.of_bytes(bytes.fromhex(j))
