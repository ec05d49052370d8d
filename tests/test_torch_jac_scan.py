"""K7 `jac_scan` with g lanes a chunk: the plain version at every group
width against golden prefix sums (as group elements) and, at g = 1,
against the sequential scan word for word; the choice of g; and, marked
`gpu`, the kernel against its plain version at every g on the card.

The file imports no JAX, so the `gpu` cases also run on the card's
machine:

    python -m pytest --noconftest -m gpu tests/test_torch_jac_scan.py -q

Tolerance: exact.  Points equal as golden points; words equal where the
order of the additions is the same (the plain version adds in the
kernel's order for the same g)."""

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
N, KC = 96, 32


def _case(group: str, seed: int = 5):
    """96 points, three chunks of 32: infinities, and a segment whose
    second point repeats its first (the P + P step); without segments,
    point 60 is the prefix sum of its chunk up to point 59.  Segment ids
    (sorted) run across lane and chunk edges."""
    Gc = GROUPS[group][0]
    r = random.Random(seed)
    gen = Gc.generator()
    pts = [gen * r.randrange(1, 1 << 20) for _ in range(N)]
    for i in (0, 9, 31, 47, 48, 49, 95):
        pts[i] = Gc.zero()
    pts[13] = pts[12]
    acc = Gc.zero()
    for p in pts[32:60]:
        acc = acc + p
    pts[60] = acc
    bounds = sorted(r.sample(range(1, N), 17) + [12, 13])
    seg, cur = [], 0
    for i in range(N):
        if cur < len(bounds) and bounds[cur] == i:
            cur += 1
        seg.append(cur)
    seg[13] = seg[12]
    return pts, torch.tensor(seg, dtype=torch.int32)


def _golden(pts, seg, Gc):
    out = []
    for i, p in enumerate(pts):
        if i % KC == 0 or (seg is not None and seg[i] != seg[i - 1]):
            acc = Gc.zero()
        acc = acc + p
        out.append(acc)
    return out


@pytest.mark.parametrize("g", WIDTHS)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_scan_equals_golden_prefix_sums(group, g):
    Gc, pack, unpack = GROUPS[group]
    pts, seg = _case(group)
    P = pack(pts)
    for s in (None, seg):
        want = _golden(pts, None if s is None else s.tolist(), Gc)
        assert unpack(K.jac_scan_plain(P, KC, s, g)) == want


def _sequential(points, K_, seg):
    """The one-thread scan, add by add: acc + point t, restarting at each
    chunk and where seg changes."""
    o = K._OPS[K.group_of(points[0])]
    n = points[0].shape[-1]
    outs, acc = [], None
    for c in range(n):
        cur = tuple(x[..., c:c + 1] for x in points)
        if c % K_ == 0 or (seg is not None and seg[c] != seg[c - 1]):
            acc = cur
        else:
            acc = K._add(acc, cur, o)
        outs.append(acc)
    return tuple(torch.cat([a[i] for a in outs], dim=-1) for i in range(3))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_one_lane_is_the_sequential_scan(group):
    Gc, pack, _unpack = GROUPS[group]
    pts, seg = _case(group, seed=9)
    P = pack(pts)
    for s in (None, seg):
        got = K.jac_scan_plain(P, KC, s, 1)
        want = _sequential(P, KC, s)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# The chunks of the G2 MSM's K7 scans (its carry scans, segmented) at
# 2^16 (Groth16) and at 2^17 (the Sapling Spend cell's domain)
G2_SCAN_LEVELS = (1280, 40, 2560, 80)


@pytest.mark.parametrize("chunks", G2_SCAN_LEVELS)
def test_g2_width_at_the_level_shapes_adds_to_golden(chunks):
    """The plain scan at the G2 width `jac_scan_group` picks for each of
    the MSM's level shapes, with restarts, gives the golden prefix
    sums."""
    g = K.jac_scan_group(chunks, KC, "g2")
    assert g & (g - 1) == 0 and g <= K.max_group("g2") and KC % g == 0
    Gc, pack, unpack = GROUPS["g2"]
    pts, seg = _case("g2", seed=13)
    want = _golden(pts, seg.tolist(), Gc)
    assert unpack(K.jac_scan_plain(pack(pts), KC, seg, g)) == want


def test_group_width_is_a_pure_function_of_the_shapes():
    # the chunks of the provers' scans: Groth16 G1 5,120 and 160, G2 1,280
    # and 40; Pinocchio ZK G1 10,240 and 320, G2 2,560 and 80; the window
    # program's 8,192 tails
    chunks = (5120, 160, 1280, 40, 10240, 320, 2560, 80, 256)
    assert [K.jac_scan_group(c, 32, "g1") for c in chunks] == [
        8, 32, 16, 32, 8, 32, 8, 32, 32]
    assert K.jac_scan_group(129, 64, "g1") == 32
    # G2's thread pairs at the cells' K7 calls: keygen's table scan and
    # the 2^20 prove's level 1 at g = 1, the rest at 16
    g2_calls = (32768, 1024, 32, 16384, 512, 16, 2560, 1280, 80, 40)
    assert [K.jac_scan_group(c, 32, "g2") for c in g2_calls] == [
        1, 16, 16, 1, 16, 16, 16, 16, 16, 16]
    for group, most in (("g1", 32), ("g2", 16)):
        for chunks in (1, 3, 100, 1024, 5120, 100000):
            for k in (1, 2, 8, 32, 64, 96):
                g = K.jac_scan_group(chunks, k, group)
                assert g == K.jac_scan_group(chunks, k, group)
                assert g & (g - 1) == 0 and g <= most and k % g == 0


def test_wrapper_takes_the_group_width_of_the_plain_version():
    pts, seg = _case("g1", seed=3)
    P = C.pack_g1(pts)
    g = K.jac_scan_group(N // KC, KC, "g1")
    for s in (None, seg):
        want = K.jac_scan_plain(P, KC, s, g)
        got = K.jac_scan(P, KC, s)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        K.jac_scan(P, KC, seg, g=3)
    with pytest.raises(ValueError):
        K.jac_scan(P, KC, seg, g=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("g", WIDTHS)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernel_equals_plain_at_every_width(dev, group, g):
    """K7 on the card at each g, with and without segments, and 40 chunks
    so that a block holds idle groups at every g; G2 (its thread-pair
    kernel, counted as `jac_scan_g2`) refuses g = 32."""
    pts, seg = _case(group, seed=11)
    P = tuple(torch.cat([x.to(dev)] * 14, dim=-1)[..., :40 * KC].contiguous()
              for x in GROUPS[group][1](pts))
    s = torch.cat([seg + 100 * i for i in range(14)])[:40 * KC].to(dev)
    name = "jac_scan_g2" if group == "g2" else "jac_scan"
    if g > K.max_group(group):
        with pytest.raises(ValueError):
            K.jac_scan(P, KC, s, g)
        return
    for sg in (None, s):
        before = K.LAUNCHES[name]
        got = K.jac_scan(P, KC, sg, g)
        assert K.LAUNCHES[name] == before + 1
        assert all(torch.equal(a, b)
                   for a, b in zip(got, K.jac_scan_plain(P, KC, sg, g)))
