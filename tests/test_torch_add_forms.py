"""K2's add in its three launch forms: the plain versions on the CPU
against the JAX package (`_hs_segmented_scan`, `_seg_scan_auto`) and the
golden curve, the width function, and K5's zero fill that the bucket
assembly's carry add relies on; marked `gpu`, each form's kernel against
its plain version at every lane width (they skip without a card).  The
JAX package is imported inside the `jref` fixture, so the `gpu` cases
also run where JAX is absent (the card's machine):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_add_forms.py -q
    python -m pytest --noconftest -m gpu tests/test_torch_add_forms.py -q

Tolerance: exact.  Points of the two packages compare as golden affine
points (by their encodings) and as words after repacking; the kernels'
outputs equal their plain versions' words."""

import random
import types

import numpy as np
import pytest
import torch

from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FQ

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

GROUPS = {"g1": (G1, C.pack_g1, C.unpack_g1),
          "g2": (G2, C.pack_g2, C.unpack_g2)}


@pytest.fixture(scope="module")
def jref():
    """The JAX package's scans, jitted once per group (XLA then compiles
    each once per width), and its field vtables."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from zukelang_tpu.ops import curve_jax as CJ
    from zukelang_tpu.ops import msm as jmsm
    ops = {"g1": CJ.FQ_OPS, "g2": CJ.FQ2_OPS}

    def jit(fn, o):
        return jax.jit(lambda p, s: fn(p, s, o))
    return types.SimpleNamespace(
        jnp=jnp,
        hs={g: jit(jmsm._hs_segmented_scan, o) for g, o in ops.items()},
        auto={g: jit(jmsm._seg_scan_auto, o) for g, o in ops.items()})


def _b(points):
    """Golden points -> their compressed bytes."""
    return [p.to_compressed_bytes() for p in points]


def _golden_points(group, n, seed, inf_every=7):
    """n multiples k G from a numpy seed, every inf_every-th infinity."""
    gcls = GROUPS[group][0]
    ks = np.random.RandomState(seed).randint(1, 1 << 30, size=n)
    return [gcls.zero() if i % inf_every == 3 else gcls.generator() * int(k)
            for i, k in enumerate(ks)]


def _packed(group, pts):
    """The port's batch of the points (Z = 1, or 0 at infinity) and the
    same words in the JAX package's layout."""
    P = GROUPS[group][1](pts)
    return P, tuple(np.asarray(x) for x in C.to_jax(P))


def _words_equal(got, want) -> bool:
    """The port's batch against a JAX batch, word for word."""
    return all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(got), want))


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("n", [5, 20, 40, 80])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_seg_scan_small_plain_matches_jax_hs_segmented_scan(jref, group, n,
                                                            segmented):
    """Form (b)'s plain version, the rounds the kernel runs in one block,
    against the JAX package's Hillis-Steele scan: the same words after
    repacking, and the same golden points."""
    pts = _golden_points(group, n, seed=n + len(group))
    P, JP = _packed(group, pts)
    seg = ((np.arange(n) * 3) // 7 if segmented
           else np.zeros(n)).astype(np.int32)
    got = K.seg_scan_small(P, torch.from_numpy(seg))
    want = jref.hs[group](JP, jref.jnp.asarray(seg))
    assert _words_equal(got, want)
    unpack = GROUPS[group][2]
    assert _b(unpack(got)) == _b(unpack(C.from_jax(want)))
    assert K.LAUNCHES["point_add"] == 0


def test_hs_segmented_scan_takes_the_small_scan_up_to_its_width(monkeypatch):
    """`msm._hs_segmented_scan` runs form (b) up to SEG_SCAN_SMALL_MAX
    points and the rounds of form (a) above: the same words either way."""
    calls = []
    real = K.seg_scan_small

    def spy(points, seg, lanes=None):
        calls.append(points[0].shape[-1])
        return real(points, seg, lanes)
    monkeypatch.setattr(K, "seg_scan_small", spy)
    n = K.SEG_SCAN_SMALL_MAX
    P, _ = _packed("g1", _golden_points("g1", 8, 3))
    P = tuple(x.repeat(1, n // 8 + 1) for x in P)          # n + 8 points
    seg = torch.arange(n + 8, dtype=torch.int32) // 5
    big = msm._hs_segmented_scan(P, seg)
    small = msm._hs_segmented_scan(tuple(x[:, :n] for x in P), seg[:n])
    assert calls == [n]
    assert all(torch.equal(a[:, :n], b) for a, b in zip(big, small))
    with pytest.raises(ValueError):
        K.seg_scan_small(P, seg)


def _old_carry_add(scanned, car, seg, K_):
    """The carry add `_seg_scan_auto` made before form (c): the second
    operand built at full width by selects and repeat_interleave."""
    n = seg.shape[-1]
    M = n // K_
    last_seg, first_seg = seg[K_ - 1::K_], seg[0::K_]
    match = torch.zeros(M, dtype=torch.bool)
    match[1:] = last_seg[:-1] == first_seg[1:]
    elem = (seg.reshape(M, K_) == first_seg[:, None]).reshape(n)
    shifted = tuple(torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]],
                              dim=-1) for v in car)
    cin = tuple(K.select_lanes(elem, torch.repeat_interleave(
        K.select_lanes(match, v, torch.zeros_like(v)), K_, dim=-1),
        torch.zeros_like(x)) for v, x in zip(shifted, scanned))
    return K.point_add_plain(scanned, cin)


@pytest.mark.parametrize("group,n", [("g1", 128), ("g2", 64)])
def test_seg_scan_auto_carry_add_matches_jax_and_the_old_glue(jref, group,
                                                              n):
    """`_seg_scan_auto` with form (c) (K7, the recursion, one carry add):
    against the JAX package's `_seg_scan_auto` (its CPU path, the XLA
    log-depth scan) as golden points, and word for word against the
    carry add built by the selects it replaces.  Segments of 24 and 1
    cross the chunk boundaries of 32; infinities among the points."""
    pts = _golden_points(group, n, seed=n)
    P, JP = _packed(group, pts)
    seg = np.concatenate([np.arange(n - 8) // 24,
                          (n - 8) // 24 + 1 + np.arange(8)]).astype(np.int32)
    got = msm._seg_scan_auto(P, torch.from_numpy(seg))
    want = jref.auto[group](JP, jref.jnp.asarray(seg))
    unpack = GROUPS[group][2]
    assert _b(unpack(got)) == _b(unpack(C.from_jax(want)))
    seg_t = torch.from_numpy(seg)
    scanned = K.jac_scan(P, 32, seg_t)
    car = msm._seg_scan_auto(tuple(x[..., 31::32] for x in scanned),
                             seg_t[31::32])
    old = _old_carry_add(scanned, car, seg_t, 32)
    assert all(torch.equal(a, b) for a, b in zip(got, old))


def test_point_add_carry_plain_is_the_add_of_the_gathered_carry():
    """Form (c): lane i adds car[idx[i]], and keeps its point where
    idx[i] < 0 (the add of infinity)."""
    P, _ = _packed("g1", _golden_points("g1", 12, 5))
    car, _ = _packed("g1", _golden_points("g1", 4, 6, inf_every=3))
    idx = torch.tensor([-1, 0, 1, 2, 3, -1, 3, 0, -1, 1, 2, -1],
                       dtype=torch.int32)
    got = K.point_add_carry(P, car, idx)
    for i in range(12):
        j = int(idx[i])
        lane = tuple(x[:, i:i + 1] for x in P)
        want = (lane if j < 0 else
                K.point_add_plain(lane, tuple(x[:, j:j + 1] for x in car)))
        assert all(torch.equal(g[:, i:i + 1], w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        K.point_add_carry(P, car, idx[:5])


def _signed_window_case(group, n, c, windows, seed):
    """Affine bases, signed digits (windows, n) and the golden bucket sums
    of every window: bucket d = sum of sign(digit) P over |digit| = d."""
    gcls = GROUPS[group][0]
    pts = _golden_points(group, n, seed, inf_every=11)
    half = 1 << (c - 1)
    rs = np.random.RandomState(seed)
    dig = (rs.randint(0, 2 * half, size=(windows, n)) - (half - 1)).astype(
        np.int32)
    dig[:, 1] = dig[:, 0]                          # a repeated digit
    nb = msm.n_buckets(c)
    golden = []
    for w in range(windows):
        sums = [gcls.zero() for _ in range(nb)]
        for p, d in zip(pts, dig[w]):
            sums[abs(int(d))] = sums[abs(int(d))] + (p if d >= 0 else -p)
        golden += sums
    aff = C.to_affine(GROUPS[group][1](pts))
    return aff, torch.from_numpy(dig), golden


@pytest.mark.parametrize("group,n", [("g1", 128), ("g2", 64)])
def test_assemble_buckets_batched_carry_add_matches_golden(group, n):
    """The bucket phase of two windows side by side (`_window_v2`, K5) and
    `_assemble_buckets_batched` on form (c), with K5's tails taken as they
    are: every bucket equals its golden sum."""
    c, windows = 4, 2
    aff, dig, golden = _signed_window_case(group, n, c, windows, seed=n)
    rows = msm._prep_rows(aff)
    bases = torch.zeros(windows, dtype=torch.int64)
    outs = msm._window_v2(rows, dig, bases, c, group)
    assert not bool(outs[7])
    got = msm._assemble_buckets_batched(outs, windows, msm.n_buckets(c),
                                        n // msm.CHUNK, group)
    assert _b(GROUPS[group][2](got)) == _b(golden)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k5_bucket_tails_are_zero_where_a_window_has_no_digit(group):
    """K5's plain version zero-fills the bucket tails of digits a window
    does not hold (`valid` false), so the bucket assembly adds them as
    infinity without a select of its own."""
    c, n = 5, 64
    aff, dig, _ = _signed_window_case(group, n, c, 2, seed=3)
    outs = msm._window_v2(msm._prep_rows(aff), dig,
                          torch.zeros(2, dtype=torch.int64), c, group)
    tail, valid = outs[1], outs[4].reshape(-1)
    assert bool((~valid).any()) and bool(valid.any())
    for t in tail:
        assert bool((t[:, ~valid] == 0).all())


def test_point_lanes_is_a_pure_function_of_the_shapes():
    """The add's and the small scan's width: one of the built widths, the
    same for the same shapes; for the add the widest group on the
    narrowest launches and one thread a point on the widest; for the
    small scan at the provers' tail and combine widths, the width the
    sweep measured fastest (G1 5, 10: 4; 160: 1; G2 20: 8, 40: 4, 80: 1).
    K3's chain has one width a group, the widest built."""
    for op in ("add", "scan"):
        for group in ("g1", "g2"):
            for n in (1, 5, 16, 20, 40, 80, 160, 1280, 5120, 8192, 40960,
                      81940, 163840, 327760):
                lanes = K.point_lanes(group, n, op)
                assert lanes in K.POINT_LANES[group]
                assert lanes == K.point_lanes(group, n, op)
            if op != "scan":
                assert K.point_lanes(group, 5, op) == max(K.POINT_LANES[group])
                assert K.point_lanes(group, 1 << 22, op) == 1
    assert [K.point_lanes(g, n, "scan") for g, n in (
        ("g1", 5), ("g1", 10), ("g1", 160), ("g2", 20), ("g2", 40),
        ("g2", 80))] == [4, 4, 1, 8, 4, 1]
    assert K.MADD_CHAIN_LANES == {g: max(K.POINT_LANES[g])
                                  for g in ("g1", "g2")}
    with pytest.raises(ValueError):
        K.point_lanes("g1", 16, "madd")
    P, _ = _packed("g1", _golden_points("g1", 2, 1))
    for L in (3, 8):
        with pytest.raises(ValueError):
            K.point_add(P, P, lanes=L)


def test_fq_mul_chain_is_reps_dependent_products():
    """The probe behind the chain bounds: a * b^reps * R^-reps mod p on
    one Fq element, for Python ints from a numpy seed; it refuses a batch
    of elements and a negative count."""
    rs = np.random.RandomState(7)
    a, b = (int.from_bytes(rs.bytes(48), "little") % FQ.p for _ in range(2))
    rinv = pow(FQ.R, -1, FQ.p)
    for reps in (0, 1, 5):
        got = K.fq_mul_chain(F.pack([a], FQ), F.pack([b], FQ), reps)
        assert F.unpack(got, FQ) == [a * pow(b * rinv, reps, FQ.p) % FQ.p]
    with pytest.raises(ValueError):
        K.fq_mul_chain(F.pack([a, b], FQ), F.pack([a, b], FQ), 1)
    with pytest.raises(ValueError):
        K.fq_mul_chain(F.pack([a], FQ), F.pack([b], FQ), -1)


# ---------------------------------------------------------------------------
# On the card: each form's kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_points(group, n, seed, dev, inf_every=9):
    r = random.Random(seed)

    def coord():
        c = F.pack([r.randrange(FQ.p) for _ in range(n)], FQ, dev)
        if group == "g2":
            c = torch.stack([c, F.pack([r.randrange(FQ.p) for _ in range(n)],
                                       FQ, dev)])
        return c
    X, Y, Z = coord(), coord(), coord()
    Z[..., ::inf_every] = 0
    return X, Y, Z


def _special_lanes(group, P, Q):
    """Q with P == Q lanes (every 6th from 1) and P == -Q (from 2)."""
    Q = [x.clone() for x in Q]
    for i in range(3):
        Q[i][..., 1::6] = P[i][..., 1::6]
    Q[0][..., 2::6] = P[0][..., 2::6]
    Q[2][..., 2::6] = P[2][..., 2::6]
    neg = F.fq2_neg(P[1]) if group == "g2" else F.neg(P[1], FQ)
    Q[1][..., 2::6] = neg[..., 2::6]
    return tuple(Q)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_kernel_equals_plain_at_every_width(dev, group):
    for n in (5, 300):
        P = _rand_points(group, n, 3, dev)
        Q = _special_lanes(group, P, _rand_points(group, n, 5, dev, 4))
        want = K.point_add_plain(P, Q)
        for L in K.POINT_LANES[group]:
            before = K.LAUNCHES["point_add"]
            assert _equal(K.point_add(P, Q, L), want)
            assert K.LAUNCHES["point_add"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_carry_kernel_equals_plain_at_every_width(dev, group):
    n, nq = 300, 40
    P = _rand_points(group, n, 7, dev)
    car = _rand_points(group, nq, 11, dev, 5)
    idx = ((torch.arange(n, device=dev) * 7) % (nq + 9) - 9).to(torch.int32)
    want = K.point_add_carry_plain(P, car, idx)
    for L in K.POINT_LANES[group]:
        assert _equal(K.point_add_carry(P, car, idx, L), want)


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_seg_scan_small_kernel_equals_plain_at_every_width(dev, group):
    for n in (1, 5, 40, 80, K.SEG_SCAN_SMALL_MAX):
        P = _rand_points(group, n, n, dev, 6)
        for seg in (torch.arange(n, device=dev) // 7,
                    torch.zeros(n, device=dev)):
            seg = seg.to(torch.int32)
            want = K.seg_scan_small_plain(P, seg)
            for L in K.POINT_LANES[group]:
                before = K.LAUNCHES["point_add"]
                assert _equal(K.seg_scan_small(P, seg, L), want)
                assert K.LAUNCHES["point_add"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k5_kernel_tails_are_zero_where_a_window_has_no_digit(dev, group):
    c, n = 8, 256                     # 129 buckets: some hold no digit
    aff, dig, _ = _signed_window_case(group, n, c, 2, seed=9)
    aff = tuple(x.to(dev) for x in aff)
    outs = msm._window_v2(msm._prep_rows(aff), dig.to(dev),
                          torch.zeros(2, dtype=torch.int64, device=dev), c,
                          group)
    valid = outs[4].reshape(-1)
    assert bool((~valid).any())
    assert all(bool((t[:, ~valid] == 0).all()) for t in outs[1])


@pytest.mark.gpu
def test_fq_mul_chain_kernel_equals_plain(dev):
    r = random.Random(8)
    a, b = (F.pack([r.randrange(FQ.p)], FQ, dev) for _ in range(2))
    before = K.LAUNCHES["mont_mul"]
    got = K.fq_mul_chain(a, b, 1000)
    assert K.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got.cpu(), K.fq_mul_chain(a.cpu(), b.cpu(), 1000))
