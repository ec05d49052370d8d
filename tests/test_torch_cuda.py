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
    """G2 runs on thread pairs, counted as `weighted_chunk_sums_g2`, and
    refuses g = 32."""
    P = _wsum_points(group, g, dev)
    name = "weighted_chunk_sums_g2" if group == "g2" else "weighted_chunk_sums"
    if g > K.max_group(group):
        with pytest.raises(ValueError):
            K.weighted_chunk_sums(P, 32, g)
        return
    before = K.LAUNCHES[name]
    got = K.weighted_chunk_sums(P, 32, g)
    assert K.LAUNCHES[name] == before + 1
    want = K.weighted_chunk_sums_plain(P, 32, g)
    for gt, wt in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(gt, wt))


def _k5_inputs(group, case, dev, B=3, n=256, nrows=300):
    """A row table of random affine points with an infinity row, and B
    rows of n positions: row indices and sorted segment ids (uniform
    digits, one digit for the whole row, or all distinct), with position
    1 repeating position 0's point in the same segment (a collision)."""
    R = 12 if group == "g1" else 24
    gen = torch.Generator(device="cpu").manual_seed(B * n + len(case))
    X = _coord(group, nrows, 71, dev).reshape(R, nrows)
    Y = _coord(group, nrows, 73, dev).reshape(R, nrows)
    rows = torch.cat([X, Y]).t().contiguous()
    rows[7] = 0                                        # affine infinity
    idx = torch.randint(0, nrows, (B, n), generator=gen).to(torch.int32)
    idx[:, 5] = 7
    if case == "uniform":
        seg = torch.sort(torch.randint(0, 40, (B, n), generator=gen))[0]
    elif case == "equal":
        seg = torch.full((B, n), 3)
    else:
        seg = torch.arange(n).expand(B, n)
    seg = seg.to(torch.int32).contiguous()
    seg[:, 1] = seg[:, 0]
    idx[:, 0] = idx[:, 1] = 11
    nb = int(seg.max()) + 1
    return rows, idx.to(dev), seg.to(dev), nb


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("with_nb", [False, True])
def test_bucket_scan_kernel_equals_plain(dev, group, with_nb):
    """K5 against its plain version, chunk tails, bucket tails and flags,
    on uniform, all-equal and all-distinct digits, and with one segment
    per chunk."""
    for case in ("uniform", "equal", "distinct"):
        rows, idx, seg, nb = _k5_inputs(group, case, dev)
        nb = nb if with_nb else None
        counter = ("bucket_scan_rows_g2" if group == "g2"
                   else "bucket_scan_rows")
        before = K.LAUNCHES[counter]
        got = K.bucket_scan_rows(rows, idx, seg, 32, group, nb)
        assert K.LAUNCHES[counter] == before + 1
        want = K.bucket_scan_rows_plain(rows, idx, seg, 32, group, nb)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        if with_nb:
            assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        else:
            assert got[1] is None
        assert torch.equal(got[2], want[2])
        # position 1 repeats position 0 in chunk 0 of every row; in the
        # distinct case that is the only continuing step of the chunk
        assert bool(got[2][::seg.shape[1] // 32].all())
        if case == "distinct":
            assert int(got[2].sum()) == seg.shape[0]
    got = K.bucket_scan_rows(rows, idx, None, 32, group)
    want = K.bucket_scan_rows_plain(rows, idx, None, 32, group)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[2], want[2])


def _negate_row(rows, dst, src):
    """Row dst = -(row src): the same X, Y -> p - Y (Y != 0)."""
    from zukelang_tpu_torch.params import FQ
    rows[dst] = rows[src]
    for c in range(2):
        w = rows[src, 24 + 12 * c:36 + 12 * c].cpu().tolist()
        v = sum((x & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(w))
        v = (FQ.p - v) % FQ.p
        neg = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
        rows[dst, 24 + 12 * c:36 + 12 * c] = torch.tensor(
            [x - (1 << 32) if x >= 1 << 31 else x for x in neg],
            dtype=torch.int32)


@pytest.mark.parametrize("case", ["partial_block", "fixed_base"])
def test_bucket_scan_g2_pairs_equal_plain(dev, case):
    """K5's G2 kernel (a thread pair a lane) against its plain version:
    a lane count that leaves the last block of 64 lanes part-filled,
    infinity rows, P = Q (flagged), P = -Q inside a segment, buckets no
    digit reaches; and the fixed-base mode (seg null, K = 16).  One launch
    a call, counted under its own name."""
    rows, idx, seg, nb = _k5_inputs("g2", "uniform", dev, B=5, n=32 * 13)
    Kc, nb = (16, None) if case == "fixed_base" else (32, nb + 7)
    _negate_row(rows, 20, 21)
    idx[:, Kc], idx[:, Kc + 1] = 21, 20     # a chunk that starts P, -P
    seg[:, Kc + 1] = seg[:, Kc]
    idx[:, 100:104] = 7                      # a run of infinity rows
    if case == "fixed_base":
        seg = None
    g1_before = K.LAUNCHES["bucket_scan_rows"]
    before = K.LAUNCHES["bucket_scan_rows_g2"]
    got = K.bucket_scan_rows(rows, idx, seg, Kc, "g2", nb)
    assert K.LAUNCHES["bucket_scan_rows_g2"] == before + 1
    assert K.LAUNCHES["bucket_scan_rows"] == g1_before
    want = K.bucket_scan_rows_plain(rows, idx, seg, Kc, "g2", nb)
    assert got[0][0].shape[-1] % 64 != 0     # the last block part-filled
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    if nb is not None:
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        empty = got[1][2].reshape(24, idx.shape[0], nb)[..., -7:]
        assert not bool(empty.any())         # buckets no digit reaches
    assert torch.equal(got[2], want[2])
    assert bool(got[2][::idx.shape[1] // Kc].all())   # P = Q at position 1


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_double_n_kernel_equals_plain(dev, group):
    """The chained doubling: mixed per-point counts with 0, infinity
    points, widths that leave a warp part-filled, one count for all."""
    for n in (20, 80, 301):
        P = _points(group, n, 81, dev)
        counts = ((torch.arange(n, device=dev) % 20) * 13).to(torch.int32)
        counts[3] = 0
        counts[4] = -2
        before = K.LAUNCHES["point_double"]
        got = K.point_double_n(P, counts)
        assert K.LAUNCHES["point_double"] == before + 1
        assert all(torch.equal(a, b) for a, b in
                   zip(got, K.point_double_n_plain(P, counts)))
        got5 = K.point_double_n(P, 5)
        assert all(torch.equal(a, b) for a, b in
                   zip(got5, K.point_double_n_plain(P, 5)))
        assert all(torch.equal(a, b) for a, b in
                   zip(K.point_double(P), K.point_double_plain(P)))


def _g2_words(n, gen, dev):
    """(2, 12, n) random canonical Fq2 words (the top limb below p's)."""
    c = torch.randint(0, 1 << 32, (2, 12, n), generator=gen,
                      dtype=torch.int64, device=dev).to(torch.int32)
    c[:, 11] &= 0x0FFFFFFF
    return c


def _g2_prove_points(n, seed, dev):
    """n G2 points of random words, every 9th at infinity."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    X, Y, Z = (_g2_words(n, gen, dev) for _ in range(3))
    Z[..., ::9] = 0
    return X, Y, Z, gen


def _plant_equal_and_negated(P, a, b, c, d):
    """Point b := point a (P = Q where they meet), point d := -(point c)
    (P = -Q)."""
    X, Y, Z = P
    for t in (X, Y, Z):
        t[..., b] = t[..., a]
    X[..., d] = X[..., c]
    Z[..., d] = Z[..., c]
    Y[..., d] = F.fq2_neg(Y[..., c].contiguous())


def _chunk_cols(chunks, Kc, sample, dev):
    """Columns of the chunks held against the plain version: all, or
    `sample` chunks at the start, the middle and the end."""
    if sample is None:
        return None
    mid = chunks // 2
    ch = torch.cat([torch.arange(s, s + sample, device=dev)
                    for s in (0, mid, chunks - sample)])
    return (ch[:, None] * Kc + torch.arange(Kc, device=dev)).reshape(-1), ch


@pytest.mark.parametrize("shape", ["2^16", "2^20"])
def test_g2_pair_kernels_equal_plain_at_prove_shapes(dev, shape):
    """K6 and K7 on G2 (the thread-pair kernels) at the level-1 shapes of
    a Groth16 prove's G2 MSM: 2,580 K6 chunks and 1,280 K7 chunks with
    segments at 2^16, held whole; 16,400 and 16,384 at 2^20, held on
    three runs of 64 chunks.  Infinities every 9th point; in every 5th K6
    chunk lane g - 1's first add meets P = Q, in every 7th P = -Q; in
    every 5th K7 chunk a segment opens with P, P, in every 7th with
    P, -P.  Each call raises its `_g2` counter once and no G1 counter."""
    Kc = 32
    wchunks, schunks, sample = {"2^16": (2580, 1280, None),
                                "2^20": (16400, 16384, 64)}[shape]
    # K6
    X, Y, Z, gen = _g2_prove_points(wchunks * Kc, 3, dev)
    g = K.wsum_group(wchunks, Kc, "g2")
    base = torch.arange(0, wchunks, 5, device=dev) * Kc
    _plant_equal_and_negated((X, Y, Z), base + Kc - 1, base + Kc - 1 - g
                             if g < Kc else base + Kc - 2,
                             torch.arange(0, wchunks, 7, device=dev) * Kc + 3,
                             torch.arange(0, wchunks, 7, device=dev) * Kc + 4)
    P = (X, Y, Z)
    before = dict(K.LAUNCHES)
    got = K.weighted_chunk_sums(P, Kc)
    torch.cuda.synchronize()
    moved = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS
             if K.LAUNCHES[k] != before[k]}
    assert moved == {"weighted_chunk_sums_g2": 1}
    picked = _chunk_cols(wchunks, Kc, sample, dev)
    if picked is None:
        want = K.weighted_chunk_sums_plain(P, Kc, g)
    else:
        cols, ch = picked
        want = K.weighted_chunk_sums_plain(tuple(x[..., cols] for x in P),
                                           Kc, g)
        got = tuple(tuple(x[..., ch] for x in part) for part in got)
    for gt, wt in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(gt, wt))
    # K7, with segments
    n = schunks * Kc
    X, Y, Z, gen = _g2_prove_points(n, 5, dev)
    steps = torch.randint(0, 2, (n,), generator=gen, device=dev)
    at5 = torch.arange(0, schunks, 5, device=dev) * Kc + 12
    at7 = torch.arange(0, schunks, 7, device=dev) * Kc + 20
    for a in (at5, at7):
        steps[a], steps[a + 1], Z[..., a] = 1, 0, 1
    _plant_equal_and_negated((X, Y, Z), at5, at5 + 1, at7, at7 + 1)
    seg = torch.cumsum(steps, 0).to(torch.int32)
    P = (X, Y, Z)
    g = K.jac_scan_group(schunks, Kc, "g2")
    before = dict(K.LAUNCHES)
    got = K.jac_scan(P, Kc, seg)
    torch.cuda.synchronize()
    moved = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS
             if K.LAUNCHES[k] != before[k]}
    assert moved == {"jac_scan_g2": 1}
    picked = _chunk_cols(schunks, Kc, sample, dev)
    if picked is None:
        want = K.jac_scan_plain(P, Kc, seg, g)
    else:
        cols, _ch = picked
        want = K.jac_scan_plain(tuple(x[..., cols] for x in P), Kc,
                                seg[cols], g)
        got = tuple(x[..., cols] for x in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.parametrize("g", [None, 1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k8_bucket_scan_kernel_equals_plain(dev, group, g):
    """K8 on the flat layout at g lanes a chunk (None: `bscan_group`'s):
    random segments, affine infinity, and a repeated point right after a
    segment start in every 5th chunk, which must raise exactly those
    chunks' flags; 150 chunks, so a block holds idle groups at every g."""
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
    got, gflag = K.bucket_scan((X, Y), seg, Kc, group, g)
    assert K.LAUNCHES["bucket_scan"] == before + 1
    want, wflag = K.bucket_scan_plain((X, Y), seg, Kc, group, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    want_flag = torch.zeros(M, dtype=torch.bool, device=dev)
    want_flag[::5] = True
    assert torch.equal(gflag, wflag) and torch.equal(gflag, want_flag)


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_mont_mul_looped_equals_k1_and_plain(dev, spec):
    """3000 elements, not a multiple of the block's 128, so the last
    block is ragged."""
    a, b = _field(spec, 3000, 51, dev), _field(spec, 3000, 53, dev)
    want = K.mont_mul_plain(a, b, spec)
    before = K.LAUNCHES["mont_mul_looped"]
    got = K.mont_mul_looped(a, b, spec)
    assert K.LAUNCHES["mont_mul_looped"] == before + 1
    assert torch.equal(got, K.mont_mul(a, b, spec))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mont", [False, True])
@pytest.mark.parametrize("c", [4, 5, 13, 16])
def test_signed_digits_kernel_equals_plain(dev, c, mont):
    """K9 on 3 MSMs of 1000 scalars (0, 1 and r - 1 among them; not a
    multiple of the block's 128), standard or Montgomery form."""
    S = torch.stack([_field(FR, 1000, 61 + j, dev) for j in range(3)])
    before = K.LAUNCHES["signed_digits"]
    got = K.signed_digits(S, c, mont)
    assert K.LAUNCHES["signed_digits"] == before + 1
    assert torch.equal(got, K.signed_digits_plain(S, c, mont))


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
    P = _points("g1", 64, 5, dev)
    with pytest.raises(ValueError):
        K.point_double_n(P, torch.zeros((1, 64), dtype=torch.int32,
                                        device=dev))
    with pytest.raises(ValueError):
        K.point_double_n(P, torch.zeros(63, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        K.point_double_n(P, torch.zeros(64, dtype=torch.int64, device=dev))
    rows, idx, sg, nb = _k5_inputs("g1", "uniform", dev, B=2, n=64)
    with pytest.raises(ValueError):
        K.bucket_scan_rows(rows, idx, sg, 48, "g1")      # 64 % 48 != 0
    with pytest.raises(ValueError):
        K.bucket_scan_rows(rows, idx, sg, 32, "g2")      # G1 rows
    with pytest.raises(ValueError):
        K.bucket_scan_rows(rows, idx, None, 32, "g1", nb)  # nb needs seg
    with pytest.raises(ValueError):
        K.bucket_scan_rows(rows, idx.to(torch.int64), sg, 32, "g1")
    with pytest.raises(ValueError):
        K.bucket_scan_rows(rows[:, 1:], idx, sg, 32, "g1")
    a = _field(FQ, 64, 2, dev)
    with pytest.raises(ValueError):
        K.mont_mul_looped(a, a[:, :32], FQ)
    with pytest.raises(ValueError):
        K.mont_mul_looped(a.to(torch.int64), a.to(torch.int64), FQ)
