"""K8 `bucket_scan` with g lanes a chunk: the plain version at every group
width against golden segmented prefix sums and, for G1, against the JAX
package's log-depth segmented scan (`msm._hs_segmented_scan`, XLA on the
CPU; G2's in tests/test_torch_k8_scan_g2.py); at g = 1 word for word against the sequential scan
(`_segmented_madds`, which K5's plain version keeps); the collision flags
at every g; and the choice of g.  K8's Pallas kernel is not run:
interpret mode took over 170 s on one G1 call at n = 64
(tests/test_torch_window.py).  Marked `gpu`, the kernel against its
plain version at every g on the same cases, staged in shared memory and
in place; the file imports JAX only inside the tests that compare with
it, so on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_k8_scan.py -q

Tolerance: exact.  Points equal as compressed golden points; words equal
where the order of the additions is the same (the plain version adds in
the kernel's order for the same g)."""

import random

import pytest
import torch

from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import kernels as K

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

GROUPS = {"g1": (G1, C.pack_g1, C.unpack_g1),
          "g2": (G2, C.pack_g2, C.unpack_g2)}
WIDTHS = (1, 2, 4, 8, 16, 32)
N, KC = 128, 32


def _affine(pts, group):
    """Golden points -> the port's affine batch, (0, 0) = infinity."""
    X, Y, Z = GROUPS[group][1](pts)
    inf = (Z.reshape(-1, Z.shape[-1]) == 0).all(dim=0)
    Y = Y.clone()
    Y[..., inf] = 0
    return X, Y


def _segments(bounds):
    """Sorted segment ids of N points with a new segment at each bound."""
    seg, cur, bs = [], 0, sorted(set(bounds))
    for i in range(N):
        while cur < len(bs) and bs[cur] == i:
            cur += 1
        seg.append(cur)
    return seg


def _clean_case(group: str, seed: int = 5):
    """128 points (four chunks of 32) with no collision in the sequential
    scan: random segments that cross lane edges at every g, infinities, a
    segment P, -P, Q, and in chunk 0 a segment A, B, B from step 7, so
    that every g > 2 starts a lane (or, at g = 32, a phase-2 add) at the
    first B and meets B + B there, which the kernel resolves without a
    flag."""
    Gc = GROUPS[group][0]
    r = random.Random(seed)
    gen = Gc.generator()
    pts = [gen * r.randrange(1, 1 << 20) for _ in range(N)]
    for i in (3, 31, 47, 48, 49, 127):
        pts[i] = Gc.zero()
    pts[9] = pts[8]                                   # A, B, B at 7, 8, 9
    pts[70] = -pts[69]                                # P, -P, Q at 69-71
    bounds = r.sample(range(1, N), 20) + [7, 10, 69, 72]
    bounds = [b for b in bounds if b not in (8, 9, 70, 71)]
    return pts, _segments(bounds)


def _collision_case(group: str):
    """Collisions of the sequential scan in chunks 1 and 2 only: chunk 1 a
    segment A, B, A + B from step 6 (the third point meets the
    accumulator at step 8, a lane start for g = 4), chunk 2 a segment P,
    P from step 12."""
    Gc = GROUPS[group][0]
    r = random.Random(17)
    gen = Gc.generator()
    pts = [gen * r.randrange(1, 1 << 20) for _ in range(N)]
    pts[40] = pts[38] + pts[39]
    pts[77] = pts[76]
    bounds = [b for b in r.sample(range(1, N), 12) if not 38 <= b <= 41
              and not 76 <= b <= 78] + [38, 41, 76, 78]
    return pts, _segments(bounds)


def _golden(pts, seg, Gc):
    out = []
    for i, p in enumerate(pts):
        if i % KC == 0 or seg[i] != seg[i - 1]:
            acc = Gc.zero()
        acc = acc + p
        out.append(acc)
    return out


def _bytes(points):
    return [p.to_compressed_bytes() for p in points]


def _jax_scan(P, seg, group):
    """The JAX package's log-depth segmented scan of the same affine
    points, restarting at chunk starts and segment changes, as compressed
    points.  JAX is imported here, so the `gpu` test below also runs
    where JAX is absent."""
    import jax
    import jax.numpy as jnp
    from zukelang_tpu.ops import curve_jax as CJ
    from zukelang_tpu.ops import msm as jmsm
    ops, junpack = ((CJ.FQ2_OPS, CJ.unpack_g2) if group == "g2"
                    else (CJ.FQ_OPS, CJ.unpack_g1))
    ids = torch.tensor(seg) + 1000 * (torch.arange(N) // KC)
    jp = tuple(jnp.asarray(x) for x in C.to_jax(P))
    scan = jax.jit(lambda p, s: jmsm._hs_segmented_scan(
        CJ.affine_to_jac(p, ops), s, ops))
    return _bytes(junpack(scan(jp, jnp.asarray(ids.numpy()))))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_scan_equals_golden_at_every_width(group):
    """The golden sums; for G1 also the JAX package's scan (G2's in
    tests/test_torch_k8_scan_g2.py, apart for its XLA compile of about
    15 s on one thread)."""
    Gc, _pack, unpack = GROUPS[group]
    pts, seg = _clean_case(group)
    P = _affine(pts, group)
    s = torch.tensor(seg, dtype=torch.int32)
    want = _bytes(_golden(pts, seg, Gc))
    if group == "g1":
        assert _jax_scan(P, seg, group) == want
    for g in WIDTHS:
        got, flag = K.bucket_scan_plain(P, s, KC, group, g)
        assert not bool(flag.any()), g
        assert _bytes(unpack(got)) == want, g


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_collisions_are_flagged_where_the_sequential_scan_flags(group):
    """At every g the flagged chunks are those where the sequential scan
    meets P == Q (chunks 1 and 2), and the others hold the golden sums."""
    Gc, _pack, unpack = GROUPS[group]
    pts, seg = _collision_case(group)
    P = _affine(pts, group)
    s = torch.tensor(seg, dtype=torch.int32)
    want = _bytes(_golden(pts, seg, Gc))
    ok = [c * KC + t for c in (0, 3) for t in range(KC)]
    for g in WIDTHS:
        got, flag = K.bucket_scan_plain(P, s, KC, group, g)
        assert flag.tolist() == [False, True, True, False], g
        b = _bytes(unpack(got))
        assert [b[i] for i in ok] == [want[i] for i in ok], g


@pytest.mark.parametrize("case", ["clean", "collision"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_one_lane_is_the_sequential_scan(group, case):
    """At g = 1 the words and flags are the sequential scan's, step by
    step, as `_segmented_madds` (K5's plain scan) runs it."""
    pts, seg = (_clean_case if case == "clean" else _collision_case)(group)
    X, Y = _affine(pts, group)
    s = torch.tensor(seg, dtype=torch.int32)
    got, flag = K.bucket_scan_plain((X, Y), s, KC, group, 1)
    rows = torch.cat([X.reshape(-1, N), Y.reshape(-1, N)]).t().reshape(
        N // KC, KC, -1)
    steps = list(K._segmented_madds(rows, s.reshape(N // KC, KC), group))
    for i, w in enumerate(got):
        want = torch.stack([acc[i].reshape(-1, N // KC)
                            for _t, acc, _f in steps], dim=-1)
        assert torch.equal(w, want.reshape(w.shape))
    assert torch.equal(flag, steps[-1][2])


def test_group_width_is_a_pure_function_of_the_shapes():
    # the path's shapes: the window program's 2^18 points (8,192 chunks
    # of 32, G1), chip_smoke's 2^16 G1 and G2 (2,048 chunks)
    assert [K.bscan_group(8192, 32, "g1"), K.bscan_group(2048, 32, "g1"),
            K.bscan_group(2048, 32, "g2")] == [4, 8, 8]
    for group in ("g1", "g2"):
        for chunks in (1, 3, 100, 2048, 8192, 100000):
            for k in (1, 2, 8, 32, 64, 96):
                g = K.bscan_group(chunks, k, group)
                assert g == K.bscan_group(chunks, k, group)
                assert g & (g - 1) == 0 and g <= 32 and k % g == 0


def test_wrapper_takes_the_group_width_of_the_plain_version():
    pts, seg = _collision_case("g1")
    P = _affine(pts, "g1")
    s = torch.tensor(seg, dtype=torch.int32)
    g = K.bscan_group(N // KC, KC, "g1")
    want, wflag = K.bucket_scan_plain(P, s, KC, "g1", g)
    for in_place in (False, True):
        got, gflag = K.bucket_scan(P, s, KC, "g1", in_place=in_place)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(gflag, wflag)
    assert K.LAUNCHES["bucket_scan"] == 0
    for bad in (3, 64):
        with pytest.raises(ValueError):
            K.bucket_scan(P, s, KC, "g1", g=bad)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("g", WIDTHS)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernel_equals_plain_at_every_width(dev, group, g):
    """K8 on the card at each g on both constructed cases (the doubling
    that phase 1 resolves, P, -P, infinities, the collisions), words and
    flags; the clean case's flags all clear, the collision case's on
    chunks 1 and 2.  G1 also in place (`in_place=True`), where the
    wrapper's own form at g >= 4 is the staged one."""
    forms = (False, True) if group == "g1" else (False,)
    for case, flags in ((_clean_case, [False] * 4),
                        (_collision_case, [False, True, True, False])):
        pts, seg = case(group)
        P = tuple(x.to(dev) for x in _affine(pts, group))
        s = torch.tensor(seg, dtype=torch.int32, device=dev)
        want, wflag = K.bucket_scan_plain(P, s, KC, group, g)
        for in_place in forms:
            before = K.LAUNCHES["bucket_scan"]
            got, gflag = K.bucket_scan(P, s, KC, group, g, in_place)
            assert K.LAUNCHES["bucket_scan"] == before + 1
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert gflag.tolist() == wflag.tolist() == flags
