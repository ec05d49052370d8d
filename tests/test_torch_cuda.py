"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: without a CUDA device every test skips (the decision is
made inside the fixture, never at import).  The file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: integer outputs must be equal."""

import random

import pytest
import torch

from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.params import FQ, FR

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(spec, n, seed, dev):
    r = random.Random(seed)
    vals = [0, 1, spec.p - 1] + [r.randrange(spec.p) for _ in range(n - 3)]
    return F.pack(vals, spec, dev)


def _coord(group, n, seed, dev):
    if group == "g1":
        return _field(FQ, n, seed, dev)
    return torch.stack([_field(FQ, n, seed, dev), _field(FQ, n, seed + 1, dev)])


def _points(group, n, seed, dev):
    X, Y, Z = (_coord(group, n, seed + 7 * i, dev) for i in range(3))
    Z[..., ::9] = 0
    return X, Y, Z


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_mont_mul_kernel_equals_plain(dev, spec):
    a, b = _field(spec, 1000, 1, dev), _field(spec, 1000, 2, dev)
    before = K.LAUNCHES["mont_mul"]
    got = K.mont_mul(a, b, spec)
    assert K.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, K.mont_mul_plain(a, b, spec))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_kernels_equal_plain(dev, group):
    P = _points(group, 300, 3, dev)
    Q = list(_points(group, 300, 5, dev))
    for i in range(3):
        Q[i][..., ::4] = P[i][..., ::4]           # P + P lanes
    Q = tuple(Q)
    assert all(torch.equal(a, b) for a, b in
               zip(K.point_add(P, Q), K.point_add_plain(P, Q)))
    assert all(torch.equal(a, b) for a, b in
               zip(K.point_double(P), K.point_double_plain(P)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_madd_kernel_equals_plain(dev, group):
    """K3 and its flag: random lanes, affine infinity, Jacobian infinity,
    p == q (flagged) and p == -q lanes."""
    n = 300
    P = list(_points(group, n, 23, dev))
    qx, qy = _coord(group, n, 29, dev), _coord(group, n, 31, dev)
    one = F.ones_mont(n, FQ, dev)
    if group == "g2":
        one = torch.stack([one, torch.zeros_like(one)])
    P[2][..., 1::5] = one[..., 1::5]               # Z = 1: affine lanes
    qx[..., 1::5], qy[..., 1::5] = P[0][..., 1::5], P[1][..., 1::5]
    P[2][..., 2::5] = one[..., 2::5]
    qx[..., 2::5] = P[0][..., 2::5]
    neg = F.fq2_neg(P[1]) if group == "g2" else F.neg(P[1], FQ)
    qy[..., 2::5] = neg[..., 2::5]
    qx[..., 3::5] = qy[..., 3::5] = 0               # q = infinity
    P, Q = tuple(P), (qx, qy)
    before = K.LAUNCHES["point_madd"]
    got, gflag = K.point_madd(P, Q)
    assert K.LAUNCHES["point_madd"] == before + 1
    want, wflag = K.point_madd_plain(P, Q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(gflag, wflag) and bool(gflag[1::5].all())


def _sort_keys(case, rows, n, nkeys, dev):
    gen = torch.Generator(device="cpu").manual_seed(rows * n + nkeys)
    if case == "random":
        keys = torch.randint(0, nkeys, (rows, n), generator=gen)
    elif case == "equal":
        keys = torch.full((rows, n), nkeys - 1)
    else:                                   # distinct keys, shuffled
        keys = torch.stack([torch.randperm(nkeys, generator=gen)[:n]
                            for _ in range(rows)])
    return keys.to(torch.int32).to(dev)


@pytest.mark.parametrize("nkeys", [17, 4097, 8193, 32769])
@pytest.mark.parametrize("rows,n", [(1, 2048 * 3 + 17), (80, 5000), (3, 31)])
@pytest.mark.parametrize("case", ["random", "equal", "distinct"])
def test_digit_sort_kernel_equals_stable_sort(dev, nkeys, rows, n, case):
    """K4 against torch.sort(stable=True) word for word: widths that are
    not a multiple of the 2048-key tile, one and 80 rows, all keys equal,
    all keys distinct (where nkeys allows)."""
    if case == "distinct" and n > nkeys:
        n = nkeys
    keys = _sort_keys(case, rows, n, nkeys, dev)
    before = K.LAUNCHES["digit_sort"]
    sk, order = K.digit_sort(keys, nkeys)
    assert K.LAUNCHES["digit_sort"] == before + 1
    want_sk, want_order = torch.sort(keys, dim=-1, stable=True)
    assert torch.equal(sk, want_sk)
    assert torch.equal(order, want_order.to(torch.int32))
    psk, porder = K.digit_sort_plain(keys, nkeys)
    assert torch.equal(sk, psk) and torch.equal(order, porder)


def _wsum_points(group, g, dev, Kc=32, M=70):
    """M chunks: random points with infinities; in every 5th chunk points
    K-1 and K-1-g equal (K-2 and K-1 for g = K), the doubling case of a
    lane's first add or of the first shuffle round; in every 7th chunk a
    point next to its negation."""
    X, Y, Z = (x.clone() for x in _points(group, Kc * M, 61, dev))
    base = torch.arange(0, M, 5, device=dev) * Kc
    a, b = (base + Kc - 2, base + Kc - 1) if g == Kc else (
        base + Kc - 1 - g, base + Kc - 1)
    for c in (X, Y, Z):
        c[..., a] = c[..., b]
    base = torch.arange(0, M, 7, device=dev) * Kc + 3
    X[..., base + 1] = X[..., base]
    Z[..., base + 1] = Z[..., base]
    neg = F.fq2_neg(Y) if group == "g2" else F.neg(Y, FQ)
    Y[..., base + 1] = neg[..., base]
    return X, Y, Z


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_weighted_chunk_sums_kernel_equals_plain_every_width(dev, group, g):
    P = _wsum_points(group, g, dev)
    before = K.LAUNCHES["weighted_chunk_sums"]
    got = K.weighted_chunk_sums(P, 32, g)
    assert K.LAUNCHES["weighted_chunk_sums"] == before + 1
    want = K.weighted_chunk_sums_plain(P, 32, g)
    for gt, wt in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(gt, wt))


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("tails", [False, True])
def test_bucket_scan_kernel_equals_plain(dev, group, tails):
    Kc, M = 8, 200
    rows = 12 if group == "g1" else 24
    X = _coord(group, Kc * M, 11, dev).reshape(rows, Kc, M).transpose(0, 1)
    Y = _coord(group, Kc * M, 13, dev).reshape(rows, Kc, M).transpose(0, 1)
    pts3 = torch.cat([X, Y], dim=1).contiguous()
    pts3[2, :, ::7] = 0
    seg3 = torch.cumsum(torch.randint(0, 2, (Kc, 1, M), device=dev),
                        0).to(torch.int32)
    segp3 = torch.cat([seg3[:1], seg3[:-1]])
    (got, gf) = K.bucket_scan_rows(pts3, seg3, segp3, group, tails)
    (want, wf) = K.bucket_scan_rows_plain(pts3, seg3, segp3, group, tails)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(gf, wf)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scan_kernels_equal_plain(dev, group):
    P = _points(group, 256, 17, dev)
    seg = torch.cumsum(torch.randint(0, 2, (256,), device=dev), 0).to(
        torch.int32)
    for s in (None, seg):
        assert all(torch.equal(a, b) for a, b in
                   zip(K.jac_scan(P, 32, s), K.jac_scan_plain(P, 32, s)))
    got = K.weighted_chunk_sums(P, 32)
    want = K.weighted_chunk_sums_plain(P, 32)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = _field(FR, 64, 1, dev)
    with pytest.raises(ValueError):
        K.mont_mul(a.to(torch.int64), a.to(torch.int64), FR)
    with pytest.raises(ValueError):
        K.mont_mul(a, a[:, :32], FR)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k8_bucket_scan_kernel_equals_plain(dev, group):
    """K8 on the flat layout: random segments, affine infinity, and a
    repeated point right after a segment start in every 5th lane, which
    must raise exactly those lanes' flags."""
    Kc, M = 32, 150
    n = Kc * M
    X, Y = _coord(group, n, 41, dev), _coord(group, n, 43, dev)
    lanes = torch.arange(M, device=dev) * Kc
    X[..., lanes[::7] + 3] = 0
    Y[..., lanes[::7] + 3] = 0
    dup = lanes[::5] + 10
    X[..., dup + 1] = X[..., dup]
    Y[..., dup + 1] = Y[..., dup]
    steps = torch.randint(0, 2, (n,), device=dev)
    steps[dup], steps[dup + 1] = 1, 0
    seg = torch.cumsum(steps, 0).to(torch.int32)
    before = K.LAUNCHES["bucket_scan"]
    got, gflag = K.bucket_scan((X, Y), seg, Kc, group)
    assert K.LAUNCHES["bucket_scan"] == before + 1
    want, wflag = K.bucket_scan_plain((X, Y), seg, Kc, group)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    want_flag = torch.zeros(M, dtype=torch.bool, device=dev)
    want_flag[::5] = True
    assert torch.equal(gflag, wflag) and torch.equal(gflag, want_flag)


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_mont_mul_looped_equals_k1_and_plain(dev, spec):
    a, b = _field(spec, 3000, 51, dev), _field(spec, 3000, 53, dev)
    before = K.LAUNCHES["mont_mul_looped"]
    got = K.mont_mul_looped(a, b, spec)
    assert K.LAUNCHES["mont_mul_looped"] == before + 1
    assert torch.equal(got, K.mont_mul(a, b, spec))
    assert torch.equal(got, K.mont_mul_plain(a, b, spec))


def test_new_wrappers_refuse_bad_shapes(dev):
    X = _coord("g1", 64, 1, dev)
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.bucket_scan((X, X), seg, 48, "g1")            # 64 % 48 != 0
    with pytest.raises(ValueError):
        K.bucket_scan((X, X[:, :32]), seg, 32, "g1")
    with pytest.raises(ValueError):
        K.bucket_scan((X, X), seg, 32, "g2")             # G1 coordinates
    with pytest.raises(ValueError):
        K.bucket_scan((X, X), seg.to(torch.int64), 32, "g1")
    a = _field(FQ, 64, 2, dev)
    with pytest.raises(ValueError):
        K.mont_mul_looped(a, a[:, :32], FQ)
    with pytest.raises(ValueError):
        K.mont_mul_looped(a.to(torch.int64), a.to(torch.int64), FQ)
