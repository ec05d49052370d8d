"""A circuit of the Zcash Sapling Spend statement's shape, its witness
pool and every random scalar of a run, from a configuration, a traffic mix
and `--seed`.

The Sapling Spend statement (Zcash protocol specification, "Sapling Spend
statement" and Appendix A, "Circuit design") is an R1CS of 98,777 rows
over BLS12-381's Fr with 7 public inputs: rk (u, v), cv (u, v), the
anchor, and the nullifier multipacked into 2.  Its row-by-row listing is
not given here; the composition below is assumed, in the forms of the
bellman gadgets the statement is written in, and every gadget computes
its outputs from its inputs, so every witness of the pool satisfies every
row.  The configuration's `composition` holds the sizes:

  value          its `value_bits` bits (a boolean row each, b b = b)
                 and one packing row (sum 2^i b_i) * ONE = value
  cv             [value] V + [rcv] R: fixed-base multiplications over
                 windows of 3 bits (a 2-row lookup: b0 b1 = p, and the
                 y entry with conditional negation, up to 4 terms over
                 the window's bits and constants; x stays a linear
                 combination), each window a 3-row curve addition over
                 full-width wires; rcv a `scalar_bits` scalar (bits and
                 a packing row); cv's u, v made public (one row each)
  rk             ak + [alpha] G, the same forms; rk made public
  nk             [nsk] N, the same forms
  CRH^ivk        a BLAKE2s compression (`blake2s_blocks` of 2): the 16
                 message words' bits as boolean rows, the initial state
                 constant (bellman's UInt32::constant: no column, no
                 row), 80 G-functions of four 32-bit xors (32 rows each,
                 (2a) b = a + b - c, none where one word is constant)
                 and four modular additions (bellman's addmany: one wide
                 row, the operands' bits weighted by 2^i times ONE = the
                 33-34 result bits weighted, constant bits folded into
                 the ONE term, and a boolean row a result bit), then the
                 output words h ^ v_i ^ v_(i+8) (h constant); ivk its
                 first `ivk_bits` output bits
  pk_d           [ivk] g_d, double and add, a bit at a time: a doubling
                 (4 rows), an addition (3) and a selection (2)
  cm             with `note_commitment`: g_d's and pk_d's x decomposed
                 (`node_bits` boolean rows and one packing row each), a
                 Pedersen hash of their bits and the value's in windows
                 of 3, then + [rcm] R
  Merkle path    `merkle_levels` levels: the position bit (boolean), a
                 conditional swap of the node and the sibling (2 rows),
                 both decomposed (`node_bits` bits and a packing row
                 each), a Pedersen hash of their bits (a window: the
                 2-row lookup and a 3-row addition); the root equals the
                 public anchor where the value is not zero:
                 (root - anchor) * value = (nothing)
  rho            cm + [position] J over the path's position bits
  PRF^nf         the second BLAKE2s compression
  nf             its output bits multipacked into 2 public columns (254
                 bits, then the rest)
  the rest       doublings of pk_d (4 rows of 1-3 terms over full-width
                 wires), then squarings, up to the configuration's gates

With fewer than two BLAKE2s blocks, a missing block's output is
`digest_bits` fresh bits, each a boolean row (the CPU tests' small
circuits).  The curve arithmetic uses Montgomery-form formulas over Fr
with A = 40962 (Jubjub's Montgomery A) at points drawn from the seed;
they need not lie on a curve, since only the rows' algebra is proved.

Columns: 0 is ONE, 1-7 the public inputs (rk u, v; cv u, v; anchor;
nf 0, 1), the rest are mids in the order the gadgets allocate them.  The
rows (`Instance.gates`) are ragged: each side (offsets (G + 1), cols
(nnz), coefs (nnz)), as the program's `flat.from_arrays` takes them.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .generator import Instance
from .reference.bls12_381 import R

ONE = 0
PUBLIC = ("rk_u", "rk_v", "cv_u", "cv_v", "anchor", "nf_0", "nf_1")
MONT_A = 40962
WINDOW = 3
PACK_CAPACITY = 254                 # bits a multipacked field element holds
CONSTANTS = "zkbench/sapling-spend/constants"

BLAKE2S_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
              0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
BLAKE2S_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0))
BLAKE2S_PERSONAL = (b"Zcashivk", b"Zcash_nf")
G_LANES = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))

LC = Dict[int, int]                 # column -> coefficient
Point = Tuple[LC, LC]               # (x, y) as linear combinations


def const(c: int) -> LC:
    return {ONE: c % R}


def lin(*terms: Tuple[LC, int]) -> LC:
    """sum of scale * lc over the terms, merged by column."""
    out: LC = {}
    for lc, scale in terms:
        for col, c in lc.items():
            out[col] = (out.get(col, 0) + c * scale) % R
    return out


class R1CS:
    """Rows and witness values of an R1CS, built gadget by gadget for `k`
    witnesses at once: each column holds its k values."""

    def __init__(self, k: int):
        self.k = k
        self.values: List[List[int]] = [[1] * k]
        self.sides = tuple(([0], [], []) for _ in range(3))  # l, r, o

    @property
    def rows(self) -> int:
        return len(self.sides[0][0]) - 1

    def alloc(self, vals: Sequence[int]) -> int:
        self.values.append([v % R for v in vals])
        return len(self.values) - 1

    def value(self, lc: LC) -> List[int]:
        return [sum(c * self.values[col][j] for col, c in lc.items()) % R
                for j in range(self.k)]

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """(sum a) * (sum b) = (sum c); terms of coefficient 0 dropped."""
        for (off, cols, coefs), lc in zip(self.sides, (a, b, c)):
            for col, co in lc.items():
                if co % R:
                    cols.append(col)
                    coefs.append(co % R)
            off.append(len(cols))


# -- bits and packing ---------------------------------------------------------

def boolean(cs: R1CS, vals: Sequence[int]) -> int:
    col = cs.alloc(vals)
    cs.enforce({col: 1}, {col: 1}, {col: 1})
    return col


def pack(cs: R1CS, bits: Sequence[int], target: LC) -> None:
    """(sum 2^i b_i) * ONE = target: one row of len(bits) terms."""
    cs.enforce({b: 1 << i for i, b in enumerate(bits)}, const(1), target)


def decompose(cs: R1CS, target: LC, nbits: int) -> List[int]:
    """target's nbits bits as boolean rows, then the packing row."""
    vals = cs.value(target)
    if any(v >> nbits for v in vals):
        raise ValueError(f"a value does not fit {nbits} bits")
    bits = [boolean(cs, [(v >> i) & 1 for v in vals]) for i in range(nbits)]
    pack(cs, bits, target)
    return bits


def scalar_bits(cs: R1CS, vals: Sequence[int], nbits: int) -> List[int]:
    """A witnessed scalar: its column, its bits and the packing row."""
    return decompose(cs, {cs.alloc(vals): 1}, nbits)


# -- curve arithmetic (Montgomery form, rows of 1-7 terms) --------------------

def _div(num: List[int], den: List[int]) -> List[int]:
    return [n * pow(d, -1, R) % R for n, d in zip(num, den)]


def add(cs: R1CS, p: Point, q: Point) -> Point:
    """p + q in 3 rows: lambda (x2 - x1) = y2 - y1; lambda^2 = A + x1 +
    x2 + x3; (x1 - x3) lambda = y3 + y1."""
    (x1, y1), (x2, y2) = p, q
    vx1, vy1, vx2, vy2 = (cs.value(c) for c in (x1, y1, x2, y2))
    lam = cs.alloc(_div([b - a for a, b in zip(vy1, vy2)],
                        [b - a for a, b in zip(vx1, vx2)]))
    cs.enforce(lin((x2, 1), (x1, -1)), {lam: 1}, lin((y2, 1), (y1, -1)))
    vl = cs.values[lam]
    x3 = cs.alloc([l * l - MONT_A - a - b for l, a, b in zip(vl, vx1, vx2)])
    cs.enforce({lam: 1}, {lam: 1}, lin((const(MONT_A), 1), (x1, 1), (x2, 1),
                                       ({x3: 1}, 1)))
    y3 = cs.alloc([(a - c) * l - b for a, b, c, l
                   in zip(vx1, vy1, cs.values[x3], vl)])
    cs.enforce(lin((x1, 1), ({x3: 1}, -1)), {lam: 1}, lin(({y3: 1}, 1),
                                                          (y1, 1)))
    return {x3: 1}, {y3: 1}


def double(cs: R1CS, p: Point) -> Point:
    """2 p in 4 rows: s = x x; lambda (2 y) = 3 s + 2 A x + 1; lambda^2 =
    A + 2 x + x3; (x - x3) lambda = y3 + y."""
    x, y = p
    vx, vy = cs.value(x), cs.value(y)
    s = cs.alloc([v * v for v in vx])
    cs.enforce(x, x, {s: 1})
    lam = cs.alloc(_div([3 * a + 2 * MONT_A * b + 1
                         for a, b in zip(cs.values[s], vx)],
                        [2 * b for b in vy]))
    cs.enforce({lam: 1}, lin((y, 2)), lin(({s: 1}, 3), (x, 2 * MONT_A),
                                          (const(1), 1)))
    vl = cs.values[lam]
    x3 = cs.alloc([l * l - MONT_A - 2 * a for l, a in zip(vl, vx)])
    cs.enforce({lam: 1}, {lam: 1}, lin((const(MONT_A), 1), (x, 2),
                                       ({x3: 1}, 1)))
    y3 = cs.alloc([(a - c) * l - b for a, b, c, l
                   in zip(vx, vy, cs.values[x3], vl)])
    cs.enforce(lin((x, 1), ({x3: 1}, -1)), {lam: 1}, lin(({y3: 1}, 1),
                                                         (y, 1)))
    return {x3: 1}, {y3: 1}


def select(cs: R1CS, bit: Bit, p: Point, q: Point) -> Point:
    """q where the bit is 1, else p: (q - p) bit = out - p, per
    coordinate (2 rows)."""
    out = []
    for a, b in zip(p, q):
        va, vb = cs.value(a), cs.value(b)
        col = cs.alloc([u + (v - u) * t for u, v, t
                        in zip(va, vb, bit_vals(cs, bit))])
        cs.enforce(lin((b, 1), (a, -1)), bit_lc(bit), lin(({col: 1}, 1),
                                                         (a, -1)))
        out.append({col: 1})
    return out[0], out[1]


def lookup(cs: R1CS, bits: Sequence[int], cx: Sequence[int],
           cy: Sequence[int]) -> Point:
    """A window of 1-3 bits (b0, b1, b2): entry b0 + 2 b1 of the tables
    cx, cy (4 constants each), y negated where b2.  Rows: b0 b1 = p (with
    b1), then y; x stays a linear combination of ONE, b0, b1, p."""
    b0 = bits[0]
    b1 = bits[1] if len(bits) > 1 else None
    b2 = bits[2] if len(bits) > 2 else None
    p = None
    if b1 is not None:
        p = cs.alloc([u * v for u, v in zip(cs.values[b0], cs.values[b1])])
        cs.enforce({b0: 1}, {b1: 1}, {p: 1})

    def table(c):
        lc = {ONE: c[0] % R, b0: (c[1] - c[0]) % R}
        if b1 is not None:
            lc[b1] = (c[2] - c[0]) % R
            lc[p] = (c[3] - c[2] - c[1] + c[0]) % R
        return lc

    ly = table(cy)
    sign = lin((const(1), 1), ({b2: 1}, -2)) if b2 is not None else const(1)
    y = cs.alloc([a * b for a, b in zip(cs.value(ly), cs.value(sign))])
    cs.enforce(ly, sign, {y: 1})
    return table(cx), {y: 1}


def fixed_mul(cs: R1CS, bits: Sequence[int], start: Point,
              tables: random.Random) -> Point:
    """start + sum over windows of 3 bits of a looked-up point, each
    window a lookup and an addition (the fixed base's tables drawn from
    `tables`)."""
    acc = start
    for i in range(0, len(bits), WINDOW):
        cx = [tables.randrange(R) for _ in range(4)]
        cy = [tables.randrange(R) for _ in range(4)]
        acc = add(cs, acc, lookup(cs, bits[i:i + WINDOW], cx, cy))
    return acc


def var_mul(cs: R1CS, bits: Sequence[Bit], base: Point,
            offset: Point) -> Point:
    """offset 2^len + [bits] base, most significant bit first: a
    doubling, an addition and a selection a bit."""
    acc = offset
    for b in reversed(bits):
        acc = double(cs, acc)
        acc = select(cs, b, acc, add(cs, acc, base))
    return acc


def const_point(tables: random.Random) -> Point:
    return const(tables.randrange(R)), const(tables.randrange(R))


def inputize(cs: R1CS, lc: LC, col: int) -> None:
    """A public column equal to lc: lc * ONE = col."""
    cs.values[col] = cs.value(lc)
    cs.enforce(lc, const(1), {col: 1})


# -- BLAKE2s ------------------------------------------------------------------
# A bit is bellman's Boolean: an allocated column, its negation (1 - the
# column) or a constant, as (column, negated) or (None, value).  The
# hash's initial state is constant, so xors with it take no row and
# additions fold its bits into the ONE term.

Bit = Tuple[Optional[int], int]
Word = List[Bit]                    # 32 bits, least significant first


def bit_lc(b: Bit) -> LC:
    col, flip = b
    if col is None:
        return const(flip) if flip else {}
    return {ONE: 1, col: R - 1} if flip else {col: 1}


def bit_vals(cs: R1CS, b: Bit) -> List[int]:
    col, flip = b
    return [flip] * cs.k if col is None else [v ^ flip for v in cs.values[col]]


def _const_word(w: int) -> Word:
    return [(None, (w >> i) & 1) for i in range(32)]


def _word_bits(cs: R1CS, vals: Sequence[int]) -> Word:
    return [(boolean(cs, [(v >> i) & 1 for v in vals]), 0) for i in range(32)]


def _word_vals(cs: R1CS, word: Word) -> List[int]:
    bits = [bit_vals(cs, b) for b in word]
    return [sum(b[j] << i for i, b in enumerate(bits)) for j in range(cs.k)]


def xor_bit(cs: R1CS, a: Bit, b: Bit) -> Bit:
    """a ^ b: with a constant, the other bit or its negation (no row);
    else one row (2 x) y = x + y - c over the allocated columns, c
    negated where one of a, b is."""
    if a[0] is None:
        return b[0], b[1] ^ a[1]
    if b[0] is None:
        return a[0], a[1] ^ b[1]
    x, y = a[0], b[0]
    c = cs.alloc([u ^ v for u, v in zip(cs.values[x], cs.values[y])])
    cs.enforce({x: 2}, {y: 1}, {x: 1, y: 1, c: R - 1})
    return c, a[1] ^ b[1]


def xor_word(cs: R1CS, a: Word, b: Word) -> Word:
    return [xor_bit(cs, x, y) for x, y in zip(a, b)]


def addmany(cs: R1CS, words: Sequence[Word]) -> Word:
    """The sum mod 2^32 of 2-3 words: a constant where every operand is,
    else the result's 33-34 bits as boolean rows and one row (sum of the
    operands' bits 2^i) * ONE = (sum of the result bits 2^i)."""
    total = [sum(v) for v in zip(*(_word_vals(cs, w) for w in words))]
    if all(b[0] is None for w in words for b in w):
        return _const_word(total[0] % (1 << 32))
    nbits = (len(words) * 0xFFFFFFFF).bit_length()
    res = [boolean(cs, [(t >> i) & 1 for t in total]) for i in range(nbits)]
    cs.enforce(lin(*((bit_lc(b), 1 << i) for w in words
                     for i, b in enumerate(w))),
               const(1), {b: 1 << i for i, b in enumerate(res)})
    return [(b, 0) for b in res[:32]]


def rotr(word: Word, n: int) -> Word:
    return word[n:] + word[:n]


def blake2s(cs: R1CS, message: Sequence[Sequence[int]],
            personal: bytes) -> List[Bit]:
    """One BLAKE2s-256 compression of a 64-byte message (16 words of k
    values each) with `personal`, as the hash's only and last block: the
    message as word bits, the constant initial state, 10 rounds of 8
    G-functions, the output words.  -> the digest's 256 bits, word by
    word, least significant first (the digest is their little-endian
    bytes)."""
    h = list(BLAKE2S_IV)
    h[0] ^= 0x01010020                       # digest 32 bytes, no key
    h[6] ^= int.from_bytes(personal[:4], "little")
    h[7] ^= int.from_bytes(personal[4:], "little")
    init = h + list(BLAKE2S_IV)
    init[12] ^= 64                           # bytes hashed
    init[14] ^= 0xFFFFFFFF                   # last block
    v = [_const_word(w) for w in init]
    h_words = v[:8]
    m = [_word_bits(cs, vals) for vals in message]

    def g(a, b, c, d, x, y):
        v[a] = addmany(cs, [v[a], v[b], x])
        v[d] = rotr(xor_word(cs, v[d], v[a]), 16)
        v[c] = addmany(cs, [v[c], v[d]])
        v[b] = rotr(xor_word(cs, v[b], v[c]), 12)
        v[a] = addmany(cs, [v[a], v[b], y])
        v[d] = rotr(xor_word(cs, v[d], v[a]), 8)
        v[c] = addmany(cs, [v[c], v[d]])
        v[b] = rotr(xor_word(cs, v[b], v[c]), 7)

    for s in BLAKE2S_SIGMA:
        for j, (a, b, c, d) in enumerate(G_LANES):
            g(a, b, c, d, m[s[2 * j]], m[s[2 * j + 1]])
    out = []
    for i in range(8):
        out += xor_word(cs, xor_word(cs, h_words[i], v[i]), v[i + 8])
    return out


# -- the statement ------------------------------------------------------------

class _Draw:
    """Each witness's inputs, drawn in one order from its own stream."""

    def __init__(self, seed: int, k: int):
        self.rngs = [random.Random(f"zkbench/{seed}/sapling/{j}")
                     for j in range(k)]

    def bits(self, n: int) -> List[int]:
        return [r.getrandbits(n) for r in self.rngs]

    def field(self) -> List[int]:
        return [r.randrange(R) for r in self.rngs]

    def nonzero_bits(self, n: int) -> List[int]:
        return [1 + r.getrandbits(n) % ((1 << n) - 1) for r in self.rngs]


def _point(cs: R1CS, draw: _Draw) -> Point:
    """A witnessed point: two full-width columns."""
    return {cs.alloc(draw.field()): 1}, {cs.alloc(draw.field()): 1}


def _digest(cs: R1CS, comp: dict, block: int, draw: _Draw) -> List[Bit]:
    """The output bits of BLAKE2s block `block` (0: CRH^ivk, 1: PRF^nf)
    over a message drawn for each witness; fresh boolean bits where the
    composition has fewer blocks."""
    if block < int(comp["blake2s_blocks"]):
        return blake2s(cs, [draw.bits(32) for _ in range(16)],
                       BLAKE2S_PERSONAL[block])
    return [(boolean(cs, draw.bits(1)), 0)
            for _ in range(int(comp["digest_bits"]))]


def spend(cs: R1CS, comp: dict, draw: _Draw) -> None:
    """The statement's gadgets, in order, over columns 1-7 allocated first
    as the public inputs."""
    tables = random.Random(CONSTANTS)
    pub = dict(zip(PUBLIC, (cs.alloc([0] * cs.k) for _ in PUBLIC)))
    sb = int(comp["scalar_bits"])

    value = {cs.alloc(draw.nonzero_bits(int(comp["value_bits"]))): 1}
    v_bits = decompose(cs, value, int(comp["value_bits"]))
    rcv = scalar_bits(cs, draw.bits(sb), sb)
    cv = add(cs, fixed_mul(cs, v_bits, const_point(tables), tables),
             fixed_mul(cs, rcv, const_point(tables), tables))
    inputize(cs, cv[0], pub["cv_u"])
    inputize(cs, cv[1], pub["cv_v"])

    ak = _point(cs, draw)
    rk = fixed_mul(cs, scalar_bits(cs, draw.bits(sb), sb), ak, tables)
    inputize(cs, rk[0], pub["rk_u"])
    inputize(cs, rk[1], pub["rk_v"])
    fixed_mul(cs, scalar_bits(cs, draw.bits(sb), sb), const_point(tables),
              tables)                                   # nk = [nsk] N

    ivk = _digest(cs, comp, 0, draw)[:int(comp["ivk_bits"])]
    g_d = _point(cs, draw)
    pk_d = var_mul(cs, ivk, g_d, const_point(tables))

    nb = int(comp["node_bits"])
    cm = fixed_mul(cs, scalar_bits(cs, draw.bits(sb), sb),
                   const_point(tables), tables)         # [rcm] R
    if comp["note_commitment"]:
        note = decompose(cs, g_d[0], nb) + decompose(cs, pk_d[0], nb) + v_bits
        cm = add(cs, fixed_mul(cs, note, const_point(tables), tables), cm)

    cur, position = cm[0], []
    for _ in range(int(comp["merkle_levels"])):
        right = boolean(cs, draw.bits(1))
        sib = {cs.alloc(draw.field()): 1}
        swapped = []
        for a, b in ((cur, sib), (sib, cur)):     # left, then right
            col = cs.alloc([u + (v - u) * t for u, v, t in zip(
                cs.value(a), cs.value(b), cs.values[right])])
            cs.enforce(lin((b, 1), (a, -1)), {right: 1},
                       lin(({col: 1}, 1), (a, -1)))
            swapped.append({col: 1})
        bits = decompose(cs, swapped[0], nb) + decompose(cs, swapped[1], nb)
        cur = fixed_mul(cs, bits, const_point(tables), tables)[0]
        position.append(right)
    cs.values[pub["anchor"]] = cs.value(cur)
    cs.enforce(lin((cur, 1), ({pub["anchor"]: 1}, -1)), value, {})
    if position:
        fixed_mul(cs, position, cm, tables)             # rho

    nf = _digest(cs, comp, 1, draw)
    for name, part in (("nf_0", nf[:PACK_CAPACITY]),
                       ("nf_1", nf[PACK_CAPACITY:])):
        packed = lin(*((bit_lc(b), 1 << i) for i, b in enumerate(part)))
        cs.values[pub[name]] = cs.value(packed)
        cs.enforce(packed, const(1), {pub[name]: 1})
    return pk_d


def _fill(cs: R1CS, p: Point, gates: int) -> None:
    """Doublings of p (4 rows each), then squarings (1 row each), up to
    `gates` rows."""
    while gates - cs.rows >= 4:
        p = double(cs, p)
    x = p[0]
    while cs.rows < gates:
        s = cs.alloc([v * v for v in cs.value(x)])
        cs.enforce(x, x, {s: 1})
        x = {s: 1}


def trapdoor(seed: int, logn: int) -> Tuple[int, ...]:
    """alpha, beta, gamma, delta, tau from the seed, tau off the domain
    (as `generator.build` draws them)."""
    trng = random.Random(f"zkbench/{seed}/crs")
    while True:
        t = tuple(1 + trng.randrange(R - 1) for _ in range(5))
        if pow(t[4], 1 << logn, R) != 1:
            return t


def build(config: dict, traffic: dict, seed: int) -> Instance:
    """The configuration's circuit of exactly `gates` rows, the traffic's
    pool of witnesses drawn from the seed, and the trapdoor."""
    G, logn = int(config["gates"]), int(config["domain_log"])
    if G > 1 << logn:
        raise ValueError(f"{G} gates do not fit a 2^{logn} domain")
    cs = R1CS(int(traffic["witnesses"]))
    draw = _Draw(seed, cs.k)
    pk_d = spend(cs, config["composition"], draw)
    if cs.rows > G:
        raise ValueError(f"the composition takes {cs.rows} rows, more than "
                         f"{G}")
    _fill(cs, pk_d, G)
    n_vars = len(cs.values)
    ios = np.arange(len(PUBLIC) + 1, dtype=np.int64)
    gates = tuple((np.asarray(off, dtype=np.int64),
                   np.asarray(cols, dtype=np.int32), coefs)
                  for off, cols, coefs in cs.sides)
    return Instance(logn=logn, n_vars=n_vars, gates=gates, ios=ios,
                    mids=np.arange(len(ios), n_vars, dtype=np.int64),
                    witnesses=[list(w) for w in zip(*cs.values)],
                    trapdoor=trapdoor(seed, logn), seed=seed)


def row_values(side, w: Sequence[int]) -> List[int]:
    """Each row's sum of coefficient times witness value over its terms."""
    off, cols, coefs = side
    terms = [c * w[k] for k, c in zip(cols.tolist(), coefs)]
    return [sum(terms[off[g]:off[g + 1]]) % R for g in range(len(off) - 1)]


def satisfied(inst: Instance, widx: int) -> bool:
    """Every row holds: (sum l) (sum r) = (sum o)."""
    w = inst.witnesses[widx]
    l, r, o = (row_values(s, w) for s in inst.gates)
    return all(a * b % R == c for a, b, c in zip(l, r, o))


def shares(inst: Instance) -> dict:
    """The circuit's shape: terms a side, the widest row, rows by terms,
    and the mids whose value is 0 or 1 in every witness of the pool."""
    widths = np.concatenate([np.diff(off) for off, _c, _k in inst.gates])
    bits = sum(all(w[c] in (0, 1) for w in inst.witnesses)
               for c in inst.mids.tolist())
    return {"rows": len(inst.gates[0][0]) - 1, "vars": inst.n_vars,
            "nnz": [len(cols) for _o, cols, _k in inst.gates],
            "widest": int(widths.max()),
            "rows_over_3_terms": int((widths > 3).sum()),
            "bit_mids": bits, "mids": len(inst.mids)}
