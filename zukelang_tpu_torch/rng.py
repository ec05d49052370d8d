"""Deterministic randomness for inputs, CRS trapdoors, and proof blinding.

The port's own copy of `zukelang_tpu/rng.py`: the same seed gives the same
byte stream and the same scalars in both packages.

The reference threads an OCaml `Random.State` through every sampling point
(src/lib/misclib/gen.ml; keygen/prove signatures in src/lib/zk/protocol.ml:17-18).
Here randomness is explicit and injectable so CRS and proof bytes are
reproducible: protocols draw trapdoor scalars in a documented order
(SURVEY.md section 4) and an `InjectedRng` can replay an exact scalar stream
for bit-exact cross-checks.

Scalar consumption order (source order of the reference):
  Pinocchio keygen: rv, rw, s, alpha_v, alpha_w, alpha_y, beta, gamma
                    (pinocchio.ml:83-91);  ZK prove: dv, dw, dy (:428-430)
  Groth16  keygen:  alpha, beta, gamma, delta, tau (groth16.ml:51-55);
                    prove: r, s (:124-125)
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from . import params
from .golden.field import Fr


class Gen:
    """Counter-mode SHA-512 PRNG producing field elements and small ints."""

    def __init__(self, seed):
        if isinstance(seed, int):
            seed = seed.to_bytes(16, "little")
        self.seed = bytes(seed)
        self.counter = 0

    def _draw(self) -> int:
        h = hashlib.sha512(self.seed + self.counter.to_bytes(8, "little")).digest()
        self.counter += 1
        return int.from_bytes(h, "little")

    def fr(self) -> Fr:
        # 512-bit draw reduced mod r: bias < 2^-257, negligible.
        return Fr(self._draw() % params.R)

    # -- value generation (gen.ml:23-28, lang.ml:271-289) ------------------
    def field(self) -> Fr:
        return self.fr()

    def bool(self) -> bool:
        return bool(self._draw() & 1)

    def uint32(self) -> int:
        return self._draw() % (1 << 32)

    def int(self, bound: int) -> int:
        return self._draw() % bound


class InjectedRng:
    """Replays a fixed scalar stream — for bit-exact CRS/proof reproduction."""

    def __init__(self, scalars: Sequence[Fr]):
        self.scalars: List[Fr] = [s if isinstance(s, Fr) else Fr(s) for s in scalars]
        self.pos = 0

    def fr(self) -> Fr:
        if self.pos >= len(self.scalars):
            raise RuntimeError("InjectedRng exhausted")
        s = self.scalars[self.pos]
        self.pos += 1
        return s
