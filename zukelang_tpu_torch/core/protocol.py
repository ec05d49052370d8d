"""The protocol interface — `Protocol.S` (src/lib/zk/protocol.ml:3-21).

Both SNARK backends implement this shape:
    keygen(rng, circuit, qap) -> (pkey, vkey)
    prove(rng, qap, pkey, witness) -> proof
    verify(public_io, vkey, proof) -> bool
with JSON-serializable keys and proofs (`serialize`).  The port's own copy
of `zukelang_tpu/core/protocol.py`; its factories pass `engine=` through
(default: a `TorchEngine` on the card).

The reference wires concrete protocols through functor application
(pinocchio/test/main.ml:3-6); here any object with these methods is a
protocol — `REGISTRY` lists the built-ins.
"""

from __future__ import annotations

from typing import Protocol as _TypingProtocol, Tuple, Dict


class SnarkProtocol(_TypingProtocol):
    name: str

    def keygen(self, rng, circuit, qap) -> Tuple[object, object]: ...

    def prove(self, rng, qap, pkey, witness: Dict) -> object: ...

    def verify(self, public: Dict, vkey, proof) -> bool: ...


def registry():
    """Built-in protocol factories, keyed like the reference's test mains."""
    from ..protocols.groth16 import Groth16
    from ..protocols.pinocchio import Pinocchio
    return {
        "groth16": Groth16,
        "pinocchio": lambda **kw: Pinocchio(zk=False, **kw),
        "pinocchio_zk": lambda **kw: Pinocchio(zk=True, **kw),
    }
