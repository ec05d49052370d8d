"""Compute engines: the seam between protocol logic and kernels.

Protocols (Groth16 / Pinocchio) are written against this small batched
interface (the port's copy of `zukelang_tpu/engine/`).  `GoldenEngine`
implements it with the pure-Python backend — the direct analog of the
reference's naive folds (curve.ml:94-118).  `TorchEngine`
(`engine/torch_engine.py`) swaps in NTT-domain QAP evaluation, Pippenger
MSM and batched fixed-base scalar multiplication on the card.
"""

from .base import Engine, GoldenEngine, get_engine

__all__ = ["Engine", "GoldenEngine", "get_engine"]
