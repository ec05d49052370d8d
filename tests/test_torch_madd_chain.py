"""K3's chain (`kernels.point_madd_chain`): its plain version on the CPU
against the JAX package's fixed-base window loop and against the loop of
K3 with its doubling fix-up that phase 1 of the chunked bucket sums ran
step by step, with a lane that hits the doubling case; marked `gpu`, the
kernel against its plain version at every lane width (they skip without
a card).  The JAX package is imported inside the test that uses it, so
the `gpu` cases also run where JAX is absent (the card's machine):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_madd_chain.py -q
    python -m pytest --noconftest -m gpu tests/test_torch_madd_chain.py -q

Tolerance: exact: golden affine points across the packages (and words
after repacking), words within the port."""

import random

import numpy as np
import pytest
import torch

from zukelang_tpu_torch import params
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

GROUPS = {"g1": (G1, C.unpack_g1), "g2": (G2, C.unpack_g2)}


def _b(points):
    """Golden points -> their compressed bytes."""
    return [p.to_compressed_bytes() for p in points]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_chain_plain_matches_jax_fixed_base_window_loop(group, monkeypatch,
                                                        tmp_path):
    """The keygen's small fixed-base batch: the chain over the port's
    window table at c = 4 (64 windows, the kernel's gather of entry
    w 2^c + d_w) against the JAX package's `fixed_base_mul`, whose CPU
    path is the window loop of mixed adds (zukelang_tpu/ops/msm.py:1305-
    1314): the same words after repacking, and the golden multiples."""
    jax = pytest.importorskip("jax")
    from zukelang_tpu.ops import field_jax as FJ
    from zukelang_tpu.ops import msm as jmsm
    monkeypatch.setenv("ZUKELANG_TABLE_CACHE", str(tmp_path))
    jmsm._fixed_base_table.cache_clear()
    rs = np.random.RandomState(7)
    scs = [0, 1, params.R - 1] + [int.from_bytes(rs.bytes(32), "little")
                                  % params.R for _ in range(13)]
    c = 4
    table = msm.fixed_base_table_device(group, c, "cpu")
    digits = msm._scalars_to_windows(F.pack(scs, FR), c)
    got = K.point_madd_chain_plain(table, digits.shape[0], digits, c)
    try:
        want = jax.jit(lambda s: jmsm.fixed_base_mul(s, group, c=c))(
            FJ.pack(scs, FJ.FR))
    finally:
        jmsm._fixed_base_table.cache_clear()
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(got), want))
    gcls, unpack = GROUPS[group]
    assert _b(unpack(got)) == _b(unpack(C.from_jax(want)))
    assert _b(unpack(got)) == _b([gcls.generator() * Fr(s) for s in scs])
    assert all(torch.equal(a, b) for a, b in zip(
        got, msm.fixed_base_mul(F.pack(scs, FR), group, c=c, table=table)))


def _old_phase1(pts, d_sorted, K_):
    """Phase 1 of the chunked bucket sums as it ran before the chain: one
    K3 mixed add a step with its doubling fix-up (`ops.curve.point_madd`),
    restarting where the digit changes."""
    n = d_sorted.shape[-1]
    M = n // K_
    d2 = d_sorted.reshape(M, K_)
    p2 = tuple(x.reshape(x.shape[:-1] + (M, K_)) for x in pts)
    acc = C.affine_to_jac(tuple(x[..., 0] for x in p2))
    outs = [acc]
    for t in range(1, K_):
        cur = tuple(x[..., t] for x in p2)
        added = C.point_madd(acc, cur)
        same = d2[:, t] == d2[:, t - 1]
        acc = tuple(K.select_lanes(same, a, c)
                    for a, c in zip(added, C.affine_to_jac(cur)))
        outs.append(acc)
    return tuple(torch.stack([o[i] for o in outs], dim=-1).reshape(
        outs[0][i].shape[:-1] + (n,)) for i in range(3))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_chain_plain_matches_the_phase1_loop_with_a_doubling(group):
    """`msm._madd_chunk_scan` on affine points (the chain, every step
    kept, restarts at digit changes) word for word against the loop it
    replaces, on sorted digits where one chunk repeats a point inside its
    segment (the doubling case of the mixed add) and holds an infinity."""
    Kc, M = 8, 4
    n = Kc * M
    gcls = GROUPS[group][0]
    rs = np.random.RandomState(5)
    pts = [gcls.generator() * int(k) for k in rs.randint(1, 1 << 30, size=n)]
    d_sorted = np.sort(rs.randint(0, 5, size=n)).astype(np.int32)
    d_sorted[9] = d_sorted[8]
    pts[9] = pts[8]                  # chunk 1: the doubling case at step 1
    pts[13] = gcls.zero()
    aff = C.to_affine((C.pack_g1 if group == "g1" else C.pack_g2)(pts))
    d = torch.from_numpy(d_sorted)
    want = _old_phase1(aff, d, Kc)
    (_X, _Y, _Z), same = K.point_madd_plain(
        C.affine_to_jac(tuple(x[..., 8:9] for x in aff)),
        tuple(x[..., 9:10] for x in aff))
    assert bool(same.all())
    got = msm._madd_chunk_scan(aff, d, Kc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(
        got, K.point_madd_chain_plain(aff, Kc, seg=d, keep=True)))
    assert K.LAUNCHES["point_madd"] == 0


def test_chain_refuses_what_it_does_not_take():
    X = torch.zeros((12, 24), dtype=torch.int32)
    dig = torch.zeros((3, 5), dtype=torch.int32)
    for kw in (dict(steps=5), dict(steps=0),
               dict(steps=3, digits=dig,
                    seg=torch.zeros(24, dtype=torch.int32)),
               dict(steps=4, digits=dig),
               dict(steps=4, seg=torch.zeros(12, dtype=torch.int32)),
               dict(steps=3, digits=torch.zeros(3, dtype=torch.int32))):
        with pytest.raises(ValueError):
            K.point_madd_chain((X, X), **kw)


# ---------------------------------------------------------------------------
# On the card: the chain against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_coord(group, n, r, dev):
    c = F.pack([r.randrange(FQ.p) for _ in range(n)], FQ, dev)
    if group == "g2":
        c = torch.stack([c, F.pack([r.randrange(FQ.p) for _ in range(n)],
                                   FQ, dev)])
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_chain_kernel_equals_plain(dev, group):
    """Both forms: the window loop over a table of W 2^c entries (entry 0
    of each window infinity) on 150 lanes, one of which doubles at its
    first add; and 256 chunks of 32 random points with restarts, every
    step kept, where lane 2 repeats its first point (the doubling)."""
    r = random.Random(3)
    c, W, n = 3, 6, 150
    tX, tY = _rand_coord(group, W << c, r, dev), _rand_coord(group, W << c, r,
                                                             dev)
    tX[..., ::1 << c] = 0
    tY[..., ::1 << c] = 0
    tX[..., (1 << c) + 2] = tX[..., 2]
    tY[..., (1 << c) + 2] = tY[..., 2]
    digits = torch.randint(0, 1 << c, (W, n), device=dev).to(torch.int32)
    digits[0, 7] = digits[1, 7] = 2
    want = K.point_madd_chain_plain((tX, tY), W, digits, c)
    Kc, M = 32, 256
    X, Y = _rand_coord(group, Kc * M, r, dev), _rand_coord(group, Kc * M, r,
                                                           dev)
    X[..., 5::97] = 0
    Y[..., 5::97] = 0
    X[..., 65] = X[..., 64]               # lane 2 doubles at step 1
    Y[..., 65] = Y[..., 64]
    seg = torch.sort(torch.randint(0, 900, (Kc * M,), device=dev))[0]
    seg = seg.to(torch.int32)
    seg[65] = seg[64]
    want_c = K.point_madd_chain_plain((X, Y), Kc, seg=seg, keep=True)
    before = K.LAUNCHES["point_madd"]
    got = K.point_madd_chain((tX, tY), W, digits, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = K.point_madd_chain((X, Y), Kc, seg=seg, keep=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want_c))
    assert K.LAUNCHES["point_madd"] == before + 2
