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


def test_digit_sort_kernel_equals_stable_sort(dev):
    keys = torch.randint(0, 4097, (4, 5000), dtype=torch.int32, device=dev)
    sk, order = K.digit_sort(keys, 4097)
    psk, porder = K.digit_sort_plain(keys, 4097)
    assert torch.equal(sk, psk) and torch.equal(order, porder)


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
