"""The one traffic generator: a circuit, its witness pool and every random
scalar of a run, from a configuration, a traffic mix and `--seed`.

A configuration fixes the gate count, the domain and the public outputs;
a traffic mix fixes the pool of witnesses.  The same seed gives the same
instance, the same witnesses and the same scalars.

The gates (one term on each side of every gate, coefficient 1) are the
multiplicative chain of the program's synthetic bench: gate j writes
w_(2+j) = w_a * w_b, a and b drawn uniformly from the earlier wires (ONE,
the secret input x and the chain outputs), so every wire is a full-width
field element.

Columns: 0 is ONE, 1 the secret input x, then the chain's outputs in
gate order.  The public output is the last chain wire; ONE and it are the
public columns, the rest are mids.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .reference.bls12_381 import R

# The proves whose witness reduction is checked: REDUCTION_SAMPLE of the
# first SAMPLE_AMONG, drawn from the seed (`Instance.sample`).
REDUCTION_SAMPLE, SAMPLE_AMONG = 2, 8


@dataclass
class Instance:
    logn: int
    n_vars: int
    gates: Tuple[np.ndarray, np.ndarray, np.ndarray]   # l, r, o columns
    ios: np.ndarray              # public columns
    mids: np.ndarray             # the other columns
    witnesses: List[List[int]]   # the pool: values by column
    trapdoor: Tuple[int, ...]    # alpha, beta, gamma, delta, tau
    seed: int

    def proof_scalars(self):
        """The (r, s) of each prove in turn: an endless iterator."""
        rnd = random.Random(f"zkbench/{self.seed}/prove")
        while True:
            yield 1 + rnd.randrange(R - 1), 1 + rnd.randrange(R - 1)

    def sample(self) -> List[int]:
        """REDUCTION_SAMPLE prove indices below SAMPLE_AMONG, drawn from
        the seed."""
        rnd = random.Random(f"zkbench/{self.seed}/sample")
        return sorted(rnd.sample(range(SAMPLE_AMONG), REDUCTION_SAMPLE))


def _chain_values(x: int, a: List[int], b: List[int]) -> List[int]:
    w = [1, x]
    for ai, bi in zip(a, b):
        w.append(w[ai] * w[bi] % R)
    return w


def build(config: dict, traffic: dict, seed: int) -> Instance:
    G = int(config["gates"])
    logn = int(config["domain_log"])
    if G > 1 << logn:
        raise ValueError(f"{G} gates do not fit a 2^{logn} domain")
    rng = np.random.default_rng([seed, 0])
    # gate j writes column 2 + j from two of the columns 0 .. j + 1
    o = np.arange(2, G + 2, dtype=np.int64)
    l = rng.integers(0, o)
    r = rng.integers(0, o)

    n_vars = 2 + G
    out_col = G + 1
    ios = np.array([0, out_col], dtype=np.int64)
    mids = np.array([c for c in range(1, n_vars) if c != out_col],
                    dtype=np.int64)

    l_l, r_l = l.tolist(), r.tolist()
    witnesses = []
    for k in range(int(traffic["witnesses"])):
        wr = np.random.default_rng([seed, 1, k])
        x = int.from_bytes(wr.bytes(32), "little") % R
        witnesses.append(_chain_values(x, l_l, r_l))

    n = 1 << logn
    trng = random.Random(f"zkbench/{seed}/crs")
    while True:
        trapdoor = tuple(1 + trng.randrange(R - 1) for _ in range(5))
        if pow(trapdoor[4], n, R) != 1:      # tau off the domain
            break
    return Instance(logn=logn, n_vars=n_vars, gates=(l, r, o), ios=ios,
                    mids=mids, witnesses=witnesses, trapdoor=trapdoor,
                    seed=seed)


def satisfied(inst: Instance, widx: int) -> bool:
    """Every gate holds: w_l * w_r = w_o."""
    w = inst.witnesses[widx]
    return all(w[a] * w[b] % R == w[c] for a, b, c in
               zip(*(g.tolist() for g in inst.gates)))
