"""The shape class of a 2^20 prove at a small size: window c = 16.

At 2^20 constraints `auto_window` picks c = 16, so every MSM has 16
windows of n_buckets(16) = 32,769 buckets (32,800 padded), K4 sorts its
digits in two radix passes and the weighted reduction takes four K6
levels.  Here the same c runs over 2^8 G1 and 2^6 G2 points through the
port's plain versions, against the golden curve; and the plain point
formulas, which skip the lanes where an operand is infinity (most
buckets at this size), against the formulas on every lane.

Tolerance: exact, on canonical integers (golden points equal, words
equal, permutations equal)."""

import random

import numpy as np
import pytest
import torch

from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FQ, FR

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

C16 = 16


def _instance(group: str, logn: int, seed: int):
    """Affine bases k G (30-bit k) and full-width scalars, from a numpy
    seed -> (affine tensors, scalar tensor, golden points, scalars)."""
    rs = np.random.RandomState(seed)
    n = 1 << logn
    gen = (G1 if group == "g1" else G2).generator()
    ks = rs.randint(1, 1 << 30, size=n)
    pts = [gen * int(k) for k in ks]
    scalars = [int.from_bytes(rs.bytes(32), "little") % FR.p
               for _ in range(n)]
    scalars[3] = 0                                  # a zero digit row
    scalars[5] = (1 << (C16 - 1)) << C16            # the digit 2^(c-1)
    pack = C.pack_g1 if group == "g1" else C.pack_g2
    aff = C.to_affine(pack(pts, "cpu"))
    return aff, F.pack(scalars, FR, "cpu"), pts, scalars


def _golden(group, pts, scalars):
    return (G1 if group == "g1" else G2).dot(pts, [Fr(s) for s in scalars])


@pytest.mark.parametrize("n", [1 << k for k in (6, 10, 14, 16, 18, 20, 22)])
def test_auto_window_matches_jax(n):
    assert msm.auto_window(n) == jmsm.auto_window(n)


def test_the_2_20_shapes():
    assert msm.auto_window(1 << 20) == C16
    assert msm.n_buckets(C16) == 32769
    assert K.radix_passes(msm.n_buckets(C16)) == (8, 8)
    assert -(-256 // C16) == 16                     # windows an MSM


@pytest.mark.parametrize("group,logn", [("g1", 8), ("g2", 6)])
def test_msm_staged_at_c16_equals_golden(group, logn):
    aff, S, pts, scalars = _instance(group, logn, seed=20)
    assert msm.msm_staged(aff, S, group, C16) == _golden(group, pts, scalars)


def test_msm_many_staged_deferred_at_c16_equals_golden():
    """Two G1 MSMs over two tables in one batch (32 digit rows)."""
    a = _instance("g1", 7, seed=21)
    b = _instance("g1", 7, seed=22)
    scal = torch.stack([F.to_mont(x[1], FR) for x in (a, b)])
    res = msm.msm_many_staged_deferred((a[0], b[0]), list(scal), (0, 1),
                                       group="g1", c=C16)()
    assert C.unpack_g1(res) == [_golden("g1", x[2], x[3]) for x in (a, b)]


def test_digit_sort_plain_below_32769_is_a_stable_argsort():
    keys = np.random.RandomState(23).randint(0, msm.n_buckets(C16),
                                             size=(4, 1 << 12))
    keys[:, :64] = 32768                            # the top bucket, ties
    sk, order = K.digit_sort(torch.from_numpy(keys.astype(np.int32)),
                             msm.n_buckets(C16))
    for r in range(4):
        want = np.argsort(keys[r], kind="stable")
        assert np.array_equal(order[r].numpy(), want)
        assert np.array_equal(sk[r].numpy(), keys[r][want])


def _coords(group, n, rs):
    def one():
        v = F.pack([int.from_bytes(rs.bytes(48), "little") % FQ.p
                    for _ in range(n)], FQ, "cpu")
        return v if group == "g1" else torch.stack(
            [v, F.pack([int.from_bytes(rs.bytes(48), "little") % FQ.p
                        for _ in range(n)], FQ, "cpu")])
    return [one() for _ in range(3)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_formulas_equal_the_formula_on_every_lane(group):
    """`_add`, `_madd` and `_dbl` compute their formula only where both
    operands are finite (the doubling where the words are not all zero):
    the same words as the formula on every lane, with infinity on either
    side, garbage words beside a zero Z, all-zero lanes and P == Q."""
    rs = np.random.RandomState(24)
    o, n = K._OPS[group], 48
    P, Q = _coords(group, n, rs), _coords(group, n, rs)
    P[2][..., ::3] = 0                              # P infinity (X, Y kept)
    Q[2][..., 1::4] = 0                             # Q infinity
    for x in P:
        x[..., ::5] = 0                             # all-zero lanes
    for x, y in zip(Q, P):
        x[..., 7::11] = y[..., 7::11]               # P == Q
    Qa = [x.clone() for x in Q[:2]]
    for x in Qa:
        x[..., 2::6] = 0                            # affine infinity
    P, Q, Qa = tuple(P), tuple(Q), tuple(Qa)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    assert same(K._add(P, Q, o), K._add_formula(P, Q, o))
    assert same(K._madd(P, Qa, o), K._madd_formula(P, Qa, o))
    assert same(K._dbl(P, o), K._dbl_formula(P, o))
    zero = tuple(torch.zeros_like(x) for x in P)
    assert same(K._dbl_formula(zero, o), zero)
    # no finite lane at all: nothing is computed, the words still agree
    assert same(K._add(zero, Q, o), K._add_formula(zero, Q, o))


def test_sparse_lanes_of_a_window_at_c16():
    """One window of 64 digits among 32,769 buckets: almost every bucket
    the weighted reduction sums is infinity; K6's plain version at the
    wrapper's g equals golden sum b * S_b."""
    rs = random.Random(25)
    g1 = G1.generator()
    nb = msm.n_buckets(C16)
    nbp = -(-nb // msm.CHUNK) * msm.CHUNK
    sums = [G1.zero()] * nbp
    for b in rs.sample(range(1, nb), 40):
        sums[b] = g1 * rs.randrange(1, 1 << 30)
    want = G1.zero()
    for b, s in enumerate(sums):
        want = want + s * b
    w, _s = msm._wreduce_batched(C.pack_g1(sums, "cpu"), 1, nbp)
    assert C.unpack_g1(w) == [want]
