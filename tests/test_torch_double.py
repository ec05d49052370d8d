"""K2's chained doubling: `point_double_n`'s plain version against the
golden repeated doubling, and the port's window combine (one chained
doubling launch, then the per-MSM sums) against the JAX package's
`_combine_windows` (its masked `fori_loop` of doublings, on the CPU
through the XLA curve code), G1 and G2, one and two MSMs.

Tolerance: exact — golden points by their encodings, the combine's
Jacobian limbs word for word after repacking."""

import random

import jax
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1, G2
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

GROUPS = {"g1": (G1, C.pack_g1, C.unpack_g1, CJ.FQ_OPS),
          "g2": (G2, C.pack_g2, C.unpack_g2, CJ.FQ2_OPS)}


def _b(points):
    return [p.to_compressed_bytes() for p in points]


def _jacobian(group, n, seed, zero_at=()):
    """n random points as a Jacobian batch with Z != 1 (each packed as a
    difference plus the generator), infinity at `zero_at`."""
    gcls, pack, _unpack, _ops = GROUPS[group]
    g = gcls.generator()
    r = random.Random(seed)
    pts = [g * r.randrange(1, params.R) for _ in range(n)]
    for i in zero_at:
        pts[i] = gcls.zero()
    P = K.point_add_plain(pack([p - g for p in pts]), pack([g] * n))
    return pts, P


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_double_n_plain_matches_golden_repeated_doubling(group):
    """Per-point counts 0, 1, 5 and 13 w (w = 0..3), an infinity point;
    then one count for the whole batch."""
    _gcls, _pack, unpack, _ops = GROUPS[group]
    counts = [0, 1, 5, 0, 13, 26, 39]
    pts, P = _jacobian(group, len(counts), 3, zero_at=(5,))
    before = K.LAUNCHES["point_double"]
    got = K.point_double_n(P, torch.tensor(counts, dtype=torch.int32))
    assert _b(unpack(got)) == _b([p * (1 << k) for p, k in zip(pts, counts)])
    got5 = K.point_double_n(P, 5)
    assert _b(unpack(got5)) == _b([p * 32 for p in pts])
    one = K.point_double(P)
    assert all(torch.equal(a, b) for a, b in
               zip(one, K.point_double_plain(P)))
    assert K.LAUNCHES["point_double"] == before       # no kernel on the CPU
    with pytest.raises(ValueError):
        K.point_double_n(P, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.point_double_n(P, torch.zeros((1, len(counts)), dtype=torch.int32))


@pytest.mark.parametrize("group,n_msm", [("g1", 1), ("g1", 2), ("g2", 1),
                                         ("g2", 2)])
def test_combine_windows_matches_jax(group, n_msm):
    """c = 3, W = 4 windows per MSM: window w doubled 3 w times, then the
    per-MSM sums (the log-depth totals at these widths, in both
    packages).  An infinity window in the second block."""
    c, W = 3, 4
    _gcls, _pack, unpack, ops = GROUPS[group]
    zero = (W + 1,) if n_msm > 1 else ()
    _pts, P = _jacobian(group, W * n_msm, 11 + n_msm, zero_at=zero)
    got = msm._combine_windows(P, c, W, n_msm)
    jP = tuple(jax.numpy.asarray(x) for x in C.to_jax(P))
    want = jax.jit(lambda p: jmsm._combine_windows(p, c, W, ops, group,
                                                   n_msm))(jP)
    for g, w in zip(C.to_jax(got), want):
        assert np.array_equal(g, np.asarray(w))
    assert got[0].shape[-1] == n_msm
