"""Ragged gate rows (`core.flat`): each row of a side keeps its own terms.

The witness reduction over rows of mixed widths (0, 1, 2, 3, 34, 96 and
255 terms, as in bellman's gadgets: products, xors, BLAKE2s additions,
field-element packings) equals the JAX package's over the same rows padded
to (G, K) (to 34 terms), the transforms of row sums on Python integers,
and the port's own over the dense form of the same rows; dense
and ragged input give byte-equal sides; a Sapling-shaped circuit's sides
on the device take nnz x 36 B + (G + 1) x 4 B; a Groth16 circuit with 7
public inputs proves and verifies on the host, its spans carrying the
rows' counts.

Tolerance: exact (words, bytes, proof points)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu.core import flat as jflat
from zukelang_tpu.engine import jax_engine as je
from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu_torch import bench_lib, params, util
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.engine import torch_engine as te
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import ntt
from zukelang_tpu_torch.protocols import groth16_device as gd
from zukelang_tpu_torch.rng import InjectedRng

torch.set_num_threads(1)

R = params.R
WIDTHS = (1, 3, 0, 34, 2, 255, 1, 96, 3, 1)


def _random_rows(G, V, widths, seed):
    """Three sides of G rows, row g of side s with widths[(g + s) %
    len(widths)] distinct random columns below V and random coefficients
    (some 1 and R - 1) -> [(offsets, cols, coefs)] * 3."""
    rng = random.Random(seed)
    sides = []
    for s in range(3):
        off, cols, coefs = [0], [], []
        for g in range(G):
            k = widths[(g + s) % len(widths)]
            cols += rng.sample(range(V), k)
            coefs += [rng.choice((1, R - 1, rng.randrange(R)))
                      for _ in range(k)]
            off.append(len(cols))
        sides.append((np.array(off, np.int64), np.array(cols, np.int32),
                      coefs))
    return sides


def _dense(side, V):
    """A ragged side padded to (G, K) with column V and coefficient 0."""
    off, cols, coefs = side
    G, K = len(off) - 1, max(1, int(np.diff(off).max()))
    idx = np.full((G, K), V, np.int32)
    dc = [[0] * K for _ in range(G)]
    for g in range(G):
        n = off[g + 1] - off[g]
        idx[g, :n] = cols[off[g]:off[g + 1]]
        dc[g][:n] = coefs[off[g]:off[g + 1]]
    return idx, dc


def _jax_flat(sides, V, logn):
    """The JAX package's flat circuit of the same rows, dense."""
    def side(s):
        idx, dc = _dense(s, V)
        G, K = idx.shape
        coef = np.asarray(FJ.pack_mont([c for row in dc for c in row],
                                       FJ.FR)).reshape(-1, G, K)
        z = np.zeros(1, np.int32)
        return jflat.FlatSide(idx=idx, coef=coef, t_var=z, t_gate=z,
                              t_coef=z)
    l, r, o = (side(s) for s in sides)
    return jflat.FlatCircuit(vars_sorted=list(range(V)), var_index={},
                             n_gates=len(sides[0][0]) - 1, logn=logn,
                             l=l, r=r, lhs=o)


def _circuit(widths, seed, G=40, V=300, logn=6):
    sides = _random_rows(G, V, widths, seed)
    rng = random.Random(seed + 1)
    w = [1] + [rng.randrange(R) for _ in range(V - 1)]
    return sides, w, flat.from_arrays(V, logn, *sides)


def test_mixed_width_reduction_equals_jax_dense():
    """Rows of 0-34 terms (the JAX package's dense gate load compiles for
    minutes at K = 255)."""
    sides, w, fc = _circuit((1, 3, 0, 34, 2, 1), 3)
    assert {s.widest for s in fc.sides} == {34}
    wt = flat.pack_witness_values(w)
    got = te.run_witness_reduction(fc, wt)
    want = je.run_witness_reduction(
        _jax_flat(sides, len(w), fc.logn),
        jnp.asarray(FJ.pack_mont(w + [0], FJ.FR)))
    for g, x in zip(got, want):
        assert np.array_equal(F.to_jax(g), np.asarray(x))


def test_wide_rows_reduction_equals_golden_sums_and_dense():
    """Rows of 0-255 terms: a and b are the inverse transforms of each
    row's sum of coefficient times value on Python integers; the kernel's
    pass split (tiles of 2^2 and 2^3) and the dense form give the same
    words."""
    sides, w, fc = _circuit(WIDTHS, 5)
    assert {s.widest for s in fc.sides} == {255}
    assert any(np.diff(s.offsets).min() == 0 for s in fc.sides)
    wt = flat.pack_witness_values(w)
    got = te.run_witness_reduction(fc, wt)
    n = fc.domain_size
    for (off, cols, coefs), x in zip(sides[:2], got[:2]):
        sums = [sum(c * w[k] for k, c in zip(cols[off[g]:off[g + 1]],
                                             coefs[off[g]:off[g + 1]])) % R
                for g in range(fc.n_gates)]
        evals = F.pack_mont(sums + [0] * (n - fc.n_gates), params.FR)
        assert torch.equal(ntt.intt(evals), x)
    args = (*(te.side_tensors(s, "cpu") for s in fc.sides), wt)
    for log_tile in (2, 3):
        for g, x in zip(te.witness_reduction_plain(fc.logn, log_tile)(*args),
                        got):
            assert torch.equal(g, x)
    dense = flat.from_arrays(len(w), fc.logn,
                             *(_dense(s, len(w)) for s in sides))
    for g, x in zip(te.run_witness_reduction(dense, wt), got):
        assert torch.equal(g, x)


@pytest.mark.parametrize("circuit", ["chain", "mixed"])
def test_dense_and_ragged_input_give_byte_equal_sides(circuit):
    if circuit == "chain":
        fc = bench_lib.make_synthetic_r1cs(6, seed=2, pad_log=7).fc
        V = len(fc.vars_sorted)
        sides = [(s.offsets, s.cols,
                  F.unpack_mont(F._as_tensor(s.coef), params.FR))
                 for s in fc.sides]
        assert all(s.widest == 1 and s.n_gates == 128 for s in fc.sides)
    else:
        V = 300
        sides = _random_rows(24, V, WIDTHS, 5)
    ragged = flat.from_arrays(V, 7, *sides)
    dense = flat.from_arrays(V, 7, *(_dense(s, V) for s in sides))
    for a, b in zip(ragged.sides, dense.sides):
        for name in ("offsets", "cols", "coef", "t_var", "t_gate", "t_coef"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        assert a.coef.dtype == np.uint32 and a.coef.shape == (8, a.nnz)


def test_sapling_shaped_sides_take_their_terms_bytes():
    """Rows as in the Sapling Spend circuit: mostly 1-3 terms, a few
    255-term packings and 96 | 34-term BLAKE2s additions.  On the device
    a side is nnz x 36 B + (G + 1) x 4 B, where (G, K) padding would take
    G x 255 x 36 B."""
    widths = (1,) * 40 + (3,) * 20 + (2,) * 10 + (96, 34, 255)
    G, V = 4096, 3000
    fc = flat.from_arrays(V, 12, *_random_rows(G, V, widths, 6))
    for side in fc.sides:
        off, cols, coef = te.side_tensors(side, torch.device("cpu"))
        nbytes = sum(t.numel() * t.element_size() for t in (off, cols, coef))
        assert nbytes == side.nnz * 36 + (G + 1) * 4
        assert side.widest == 255
        assert 8 * nbytes < G * side.widest * 36


def _seven_inputs():
    """A satisfiable circuit with ONE and 7 public inputs: 6 bits (b b =
    b), their packing into public 1, xors ((2a) b = a + b - c), products
    of full-width wires, and each other public input equal to a wire
    (w * ONE = input)."""
    rng = random.Random(11)
    vals = [1] + [0] * 7
    rows = []

    def alloc(v):
        vals.append(v % R)
        return len(vals) - 1
    bits = [alloc(rng.getrandbits(1)) for _ in range(6)]
    rows += [({b: 1}, {b: 1}, {b: 1}) for b in bits]
    vals[1] = sum(vals[b] << i for i, b in enumerate(bits))
    rows.append(({b: 1 << i for i, b in enumerate(bits)}, {0: 1}, {1: 1}))
    for a, b in zip(bits, bits[1:]):
        c = alloc(vals[a] ^ vals[b])
        rows.append(({a: 2}, {b: 1}, {a: 1, b: 1, c: R - 1}))
    x = alloc(rng.randrange(R))
    for k in range(2, 8):
        y = alloc(vals[x] * vals[x] + k)
        rows.append(({x: 1}, {x: 1}, {y: 1, 0: R - k}))
        vals[k] = vals[y]
        rows.append(({y: 1}, {0: 1}, {k: 1}))
        x = y
    sides = []
    for s in range(3):
        off, cols, coefs = [0], [], []
        for row in rows:
            cols += list(row[s])
            coefs += list(row[s].values())
            off.append(len(cols))
        sides.append((np.array(off), np.array(cols), coefs))
    return sides, vals, len(rows)


def test_seven_public_inputs_prove_and_verify(monkeypatch):
    monkeypatch.setattr(gd, "DEFAULT_MSM_WINDOW", 4)
    monkeypatch.setattr(gd, "DEFAULT_FB_WINDOW", 4)
    sides, vals, G = _seven_inputs()
    assert G <= 32
    util.reset()
    fc = flat.from_arrays(len(vals), 5, *sides)
    ios = list(range(8))
    crs, vkey = gd.keygen_device(
        fc, mids=list(range(8, len(vals))), ios=ios,
        rng=InjectedRng([Fr(3 + i) for i in range(5)]), device="cpu")
    assert len(vkey.ltgm_io) == 8
    proof = gd.prove_device(crs, fc, flat.pack_witness_values(vals),
                            InjectedRng([Fr(77), Fr(88)]))
    spans = {sp.name: sp.attrs for sp in util.spans()}
    nnz = sum(len(c) for _o, c, _k in sides)
    assert spans["zk.flat.from_arrays"] == {"vars": len(vals), "rows": G,
                                            "nnz": nnz, "widest": 6}
    assert spans["zk.prove.reduction"] == {"n": 32, "nnz": nnz}
    assert spans["zk.keygen.matvec"] == {"nnz": nnz}
    public = {c: Fr(vals[c]) for c in ios}
    assert gd.verify(public, vkey, proof)
    assert not gd.verify({**public, 5: Fr(vals[5] + 1)}, vkey, proof)
