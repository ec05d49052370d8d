"""Interned circuit variables with a deterministic global counter.

The port's own copy of `zukelang_tpu/core/var.py`.  Its counter is not the
JAX package's: a process that builds one program in both packages resets
both counters to the same value first (`reset`).

Mirrors the reference's `Var` (src/lib/zk/var.ml): a variable is a
(prefix, serial) pair; `make` draws from one process-global counter so that
variable identity — and therefore gate ordering and QAP gate ids — is
bit-reproducible across runs (SURVEY.md section 4 implication).

Ordering matches OCaml's polymorphic compare on (string, int): name first
(byte order), then serial.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Var:
    name: str
    id: int

    def __repr__(self):
        return f"{self.name}__{self.id}"


class _Counter:
    def __init__(self):
        self.n = 0

    def next(self) -> int:
        self.n += 1
        return self.n


_counter = _Counter()


def make(prefix: str) -> Var:
    """Fresh variable with the next serial (var.ml:14-18)."""
    return Var(prefix, _counter.next())


def reset(n: int = 0) -> None:
    """Reset the global counter — test isolation only.

    NOTE: the distinguished ONE variable (circuit.py) is allocated at import
    with serial 1, matching the reference's load-time `Var.make "ONE"`
    (circuit.ml:3); reset() does not re-allocate it.
    """
    _counter.n = n


def counter_value() -> int:
    return _counter.n
