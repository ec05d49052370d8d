"""Batch proving / verification helpers and a Fiat-Shamir transcript.

Beyond the reference's scope (it proves one statement at a time,
test.ml:25-97) but production-relevant: amortizes CRS reuse across many
proofs and compresses k Groth16 verifications from 3k pairings to k+3
Miller loops with one shared final exponentiation (small-exponent batch
verification with Fiat-Shamir-derived weights).  The port's own copy of
`zukelang_tpu/protocols/batch.py`, over the port's `multi_pairing`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

from .. import params
from ..golden.curve import G1, GT
from ..golden.field import Fr
from ..pairing import multi_pairing


class Transcript:
    """Fiat-Shamir transcript: absorb labelled byte strings / group
    elements, squeeze Fr challenges.  BLAKE2b chaining; deterministic
    across hosts."""

    def __init__(self, label: bytes = b"zukelang"):
        self._state = hashlib.blake2b(label, digest_size=64).digest()

    def absorb(self, label: bytes, data: bytes) -> "Transcript":
        h = hashlib.blake2b(digest_size=64)
        h.update(self._state)
        h.update(len(label).to_bytes(8, "little"))
        h.update(label)
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)
        self._state = h.digest()
        return self

    def absorb_point(self, label: bytes, point) -> "Transcript":
        return self.absorb(label, point.to_compressed_bytes())

    def absorb_fr(self, label: bytes, x: Fr) -> "Transcript":
        return self.absorb(label, x.n.to_bytes(32, "little"))

    def challenge_fr(self, label: bytes) -> Fr:
        h = hashlib.blake2b(digest_size=64)
        h.update(self._state)
        h.update(b"challenge")
        h.update(label)
        out = h.digest()
        self._state = hashlib.blake2b(out, digest_size=64).digest()
        return Fr(int.from_bytes(out, "little") % params.R)


def prove_many(protocol, rng, qap, pkey, witnesses: Sequence[Dict]):
    """One proof per witness against a shared proving key (CRS reuse —
    with the device protocols the CRS stays resident across the batch)."""
    return [protocol.prove(rng, qap, pkey, w) for w in witnesses]


def batch_verify_groth16(vkey, statements: Sequence[Tuple[Dict, object]],
                         transcript: Transcript = None) -> bool:
    """Verify k (public_inputs, proof) pairs against one Groth16 vkey.

    Random linear combination with Fiat-Shamir weights r_i (r_0 = 1):
        prod_i e(r_i A_i, B_i)
            == e((sum r_i) alpha, beta) * e(sum r_i L_i, gamma)
               * e(sum r_i C_i, delta)
    evaluated as one multi-pairing against GT identity — k+3 Miller loops
    and a single final exponentiation instead of 3k full pairings.
    Sound: a cheating proof survives with probability ~1/r.
    """
    statements = list(statements)
    if not statements:
        return True
    io_sorted = sorted(vkey.ltgm_io.keys())
    t = transcript or Transcript(b"groth16-batch")
    for public, proof in statements:
        if set(public.keys()) != set(io_sorted):
            return False
        t.absorb_point(b"A", proof.a)
        t.absorb_point(b"B", proof.b)
        t.absorb_point(b"C", proof.c)
        for k in io_sorted:
            t.absorb_fr(b"io", public[k])
    rs = [Fr(1)] + [t.challenge_fr(b"r%d" % i)
                    for i in range(1, len(statements))]

    pairs = []
    c_acc = G1.zero()
    lio_acc = G1.zero()
    r_sum = Fr(0)
    for r, (public, proof) in zip(rs, statements):
        pairs.append((proof.a * r, proof.b))
        c_acc = c_acc + proof.c * r
        lio = G1.dot([vkey.ltgm_io[k] for k in io_sorted],
                     [public[k] * r for k in io_sorted])
        lio_acc = lio_acc + lio
        r_sum = r_sum + r

    # move the right-hand side across: e(-X, Y) multiplies in the inverse
    alpha_rs = _vkey_alpha_g1(vkey) * r_sum
    pairs.append((-alpha_rs, _vkey_beta_g2(vkey)))
    pairs.append((-lio_acc, vkey.gm))
    pairs.append((-c_acc, vkey.d))
    return multi_pairing(pairs) == GT.zero()


def _vkey_alpha_g1(vkey):
    """Groth16 vkeys precompute e(alpha, beta); batching needs alpha/beta
    as points, so vkeys carry them (alpha_g1/beta_g2 fields)."""
    a = getattr(vkey, "alpha_g1", None)
    if a is None:
        raise ValueError(
            "vkey lacks alpha_g1 (regenerate the key with this version)")
    return a


def _vkey_beta_g2(vkey):
    b = getattr(vkey, "beta_g2", None)
    if b is None:
        raise ValueError(
            "vkey lacks beta_g2 (regenerate the key with this version)")
    return b
