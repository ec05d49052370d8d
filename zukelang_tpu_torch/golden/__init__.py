"""Golden (pure-Python) BLS12-381 backend: the port's host-side oracle,
copied from `zukelang_tpu/golden/`."""

from .field import Fr, Fq, Fq2, Fq6, Fq12
from .curve import G1, G2, GT
from .pairing import pairing, multi_pairing

__all__ = ["Fr", "Fq", "Fq2", "Fq6", "Fq12", "G1", "G2", "GT", "pairing", "multi_pairing"]
