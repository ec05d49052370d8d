"""The port's whole-MSM entry points, on the CPU (the kernels' plain
versions), against the golden oracle: `msm_g1` / `msm_g2` (the JAX
package's `_msm_impl`: unsigned windows, each window's bucket sums and
weighted reduce, Horner) on affine bases and on Jacobian bases with
random Z != 1 (a repeated point and infinity among them: the route is
collision-safe), and the resolved forms `msm_staged_device` /
`msm_many_staged_device`; and the chained doubling's plain version
(Python integers) against the torch formula.  `msm_g2` on affine bases
is held in `tests/test_torch_sharded.py`, beside the sharded MSM on the
same inputs.  2^6 terms, c = 4.

Tolerance: exact (golden points, limb words)."""

import random

import pytest
import torch

from zukelang_tpu_torch import params
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fq, Fq2, Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FQ, FR

torch.set_num_threads(1)

N = 64


def _terms(group, seed):
    r = random.Random(seed)
    g = G1.generator() if group == "g1" else G2.generator()
    pts = [g * r.randrange(1, 1 << 30) for _ in range(N - 3)]
    pts += [pts[0], (G1 if group == "g1" else G2).zero(), pts[1]]
    return pts, [r.randrange(FR.p) for _ in range(N)], r


def _jacobian(points, group, r):
    """Golden points -> a Jacobian batch with random Z != 1: (x z^2,
    y z^3, z); infinity as `C.infinity`'s (0, 1, 0)."""
    inf = C.infinity(group, 1)
    cols = []
    for pt in points:
        if pt.is_zero():
            cols.append(None)
            continue
        z = (Fq(r.randrange(2, params.P)) if group == "g1" else
             Fq2.of_ints(r.randrange(1, params.P), r.randrange(params.P)))
        z2 = z * z
        cols.append((pt.x * z2, pt.y * z2 * z, z))

    def coord(i):
        if group == "g1":
            vals = [0 if c is None else c[i].n for c in cols]
            t = F.pack_mont(vals, FQ)
        else:
            t = torch.stack([F.pack_mont([0 if c is None else getattr(
                c[i], part).n for c in cols], FQ) for part in ("c0", "c1")])
        for j, c in enumerate(cols):
            if c is None:
                t[..., j] = inf[i][..., 0]
        return t
    return tuple(coord(i) for i in range(3))


def _golden(group, pts, sc):
    return (G1 if group == "g1" else G2).dot(pts, [Fr(s) for s in sc])


def _unpack(group, p):
    return (C.unpack_g1 if group == "g1" else C.unpack_g2)(p)[0]


def test_msm_g1_affine_bases_equal_golden():
    pts, sc, _r = _terms("g1", 1)
    got = msm.msm_g1(C.pack_affine(pts, "g1"), F.pack(sc, FR), 4)
    assert _unpack("g1", got) == _golden("g1", pts, sc)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_g_jacobian_bases_equal_golden(group):
    pts, sc, r = _terms(group, 2)
    fn = msm.msm_g1 if group == "g1" else msm.msm_g2
    got = fn(_jacobian(pts, group, r), F.pack(sc, FR), 4)
    assert got[0].shape[-1] == 1
    assert _unpack(group, got) == _golden(group, pts, sc)


def test_msm_staged_device_and_many_equal_golden():
    pts, sc, r = _terms("g1", 3)
    sc2 = [r.randrange(FR.p) for _ in range(N)]
    A = C.pack_affine(pts, "g1")
    one = msm.msm_staged_device(A, F.pack(sc, FR), "g1", 4)
    assert one[0].shape[-1] == 1
    assert _unpack("g1", one) == _golden("g1", pts, sc)
    many = msm.msm_many_staged_device(
        (A,), [F.pack_mont(sc, FR), F.pack_mont(sc2, FR)], (0, 0), "g1", 4)
    assert C.unpack_g1(many) == [_golden("g1", pts, sc),
                                 _golden("g1", pts, sc2)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_doubling_chain_equals_the_torch_formula(group):
    """`point_double_n_plain` (the chain on Python integers, which every
    combine and Horner step above runs on the CPU) equals the torch
    formula `point_double_plain` applied count times, word for word: Z
    != 1, an infinity (0, 1, 0) and an all-zero lane among the points."""
    pts, _sc, r = _terms(group, 4)
    P = _jacobian(pts[:5] + pts[-3:], group, r)
    P = tuple(torch.cat([v, torch.zeros_like(v[..., :1])], -1) for v in P)
    counts = [3, 0, 1, 7, 2, 5, 4, 6, 3]
    got = K.point_double_n_plain(P, torch.tensor(counts, dtype=torch.int32))
    for i, k in enumerate(counts):
        want = tuple(v[..., i:i + 1] for v in P)
        for _ in range(k):
            want = K.point_double_plain(want)
        assert all(torch.equal(g[..., i:i + 1], w)
                   for g, w in zip(got, want)), i
