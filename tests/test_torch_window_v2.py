"""The port's batched v2 window (`msm._window_v2`: K4, then K5 gathering
the sorted, sign-applied rows itself) against the JAX package's
`_window_v2` window by window, G1 and G2, with negative digits, an
infinity point and one collision (a doubling case in K5's mixed add).

The JAX window runs its Pallas kernels as they run on the CPU: the
bitonic sort in interpret mode, and K5's kernel body
(`pallas_kernels._seg_scan_kernel2`) over its grid, one step of the
sequential t axis after another.  Pallas' interpret mode would run the
same body but spends minutes compiling K5's grid loop on the CPU at any
size, so the grid is driven here in Python, the body's refs standing on
numpy blocks.  The bitonic sort is not stable and the port's K4 is: the
order of equal digits is free, so the port's K4 is given the bitonic
sort's permutation and both windows add in the same order.

Tolerance: exact, word for word after repacking.  `tail` is compared at
the `valid` buckets only: there the JAX window holds the scan at a
clipped position (garbage) and the port zeros, and
`_assemble_buckets_batched` masks both."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1, G2
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu.ops import pallas_kernels as PK
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import msm

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

GROUPS = {"g1": (G1, CJ.pack_g1, CJ.FQ_OPS, CJ.infinity_g1),
          "g2": (G2, CJ.pack_g2, CJ.FQ2_OPS, CJ.infinity_g2)}


class _Ref:
    """A Pallas ref standing on a numpy block (writes land in the block)."""

    def __init__(self, a):
        self.a = a
        self.shape = a.shape

    def __getitem__(self, k):
        return jnp.asarray(self.a[k])

    def __setitem__(self, k, v):
        self.a[k] = np.asarray(v)


def _pallas_k5_grid(monkeypatch, pts3, seg3, segp3, group="g1",
                    tails_only=False):
    """`pallas_kernels.bucket_scan_rows` with its kernel body run over the
    grid (one block of all M lanes, t = 0 .. K-1) in Python."""
    assert not tails_only
    spec = FJ.FQ
    fq2 = group == "g2"
    kernel = functools.partial(
        PK._seg_scan_kernel2, fq2=fq2, nl=spec.nl,
        p_limbs=tuple(int(x) for x in spec.p_limbs), nprime=spec.nprime,
        one_limbs=tuple(int(x) for x in FJ._int_to_limbs(spec.r_mod_p,
                                                         spec.nl)))
    pts3, seg3, segp3 = (np.asarray(x) for x in (pts3, seg3, segp3))
    K_, R2, M = pts3.shape
    rows = R2 // 2
    outs = [np.zeros((K_, rows, M), np.uint32) for _ in range(3)]
    acc = np.zeros((3 * rows + 1, M), np.uint32)
    fl = np.zeros((8, M), np.uint32)
    for t in range(K_):
        monkeypatch.setattr(PK.pl, "program_id", lambda axis, t=t: t)
        kernel(_Ref(seg3[t:t + 1]), _Ref(segp3[t:t + 1]),
               _Ref(pts3[t:t + 1]), *(_Ref(o[t:t + 1]) for o in outs),
               _Ref(fl), _Ref(acc))
    return tuple(jnp.asarray(o) for o in outs), jnp.asarray(fl[0] != 0)


def _bitonic_rows(keys):
    """The JAX bitonic sort (interpret mode) of each row of (B, n) keys."""
    out = [PK.bitonic_argsort(jnp.asarray(r.numpy()), interpret=True)
           for r in keys]
    sk = np.stack([np.asarray(s) for s, _ in out])
    order = np.stack([np.asarray(o) for _, o in out])
    return torch.from_numpy(sk.astype(np.int32)), torch.from_numpy(
        order.astype(np.int32))


def _window_inputs(group, n, c):
    """n table points (one infinity, points 2 and 3 equal), and two
    windows of signed digits: window 0 has negative digits, window 1 puts
    the two equal points alone at digit 0, sorted first, so K5 adds the
    point to itself (the doubling case) at step 1 of chunk 0."""
    gcls, jpack, ops, _inf = GROUPS[group]
    r = random.Random(31)
    g = gcls.generator()
    pts = [g * r.randrange(1, params.R) for _ in range(n)]
    pts[5] = gcls.zero()
    pts[3] = pts[2]
    half = 1 << (c - 1)
    rs = np.random.RandomState(c)
    d0 = rs.randint(-(half - 1), half + 1, size=n)
    d1 = rs.randint(1, half + 1, size=n)
    d1[2] = d1[3] = 0
    aff = CJ.to_affine(jpack(pts), ops)
    return aff, np.stack([d0, d1]).astype(np.int32)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_v2_matches_jax_window_by_window(monkeypatch, group):
    n, c, Kc = 32, 3, 8
    M, nb = n // Kc, msm.n_buckets(c)
    _gcls, _jpack, ops, inf = GROUPS[group]
    aff, digits = _window_inputs(group, n, c)
    jrows = jmsm._prep_rows(aff)
    trows = msm._prep_rows(C.from_jax(tuple(np.asarray(x) for x in aff)))

    dig = torch.from_numpy(digits)
    monkeypatch.setattr(msm.kern, "digit_sort",
                        lambda keys, nkeys: _bitonic_rows(keys))
    bases = torch.zeros(dig.shape[0], dtype=torch.int64)
    got = msm._window_v2(trows, dig, bases, c, group, Kc)
    (tails_m, tail, mb, needs_carry, valid, last_seg, first_seg,
     collided) = got

    monkeypatch.setattr(PK, "bucket_scan_rows",
                        functools.partial(_pallas_k5_grid, monkeypatch))
    any_col = False
    for w in range(dig.shape[0]):
        want = jmsm._window_v2(jrows, jnp.asarray(digits[w]), c, ops, inf,
                               group, K=Kc)
        (jtails, jtail, jmb, jnc, jvalid, jlast, jfirst, jcol) = (
            [np.asarray(a) for a in x] if isinstance(x, tuple)
            else np.asarray(x) for x in want)
        v = valid[w].numpy()
        assert np.array_equal(v, jvalid)
        for name, a, b in (("mb", mb, jmb), ("needs_carry", needs_carry, jnc),
                           ("last_seg", last_seg, jlast),
                           ("first_seg", first_seg, jfirst)):
            assert np.array_equal(a[w].numpy(), b), name
        for gt, jt in zip(tails_m, jtails):
            part = msm._to_curve(gt[..., w * M:(w + 1) * M], group)
            assert np.array_equal(F.to_jax(part, axis=-2),
                                  jt.reshape(F.to_jax(part, axis=-2).shape))
        for gt, jt in zip(tail, jtail):
            part = F.to_jax(msm._to_curve(gt[..., w * nb:(w + 1) * nb], group),
                            axis=-2)
            jt = jt.reshape(part.shape)
            assert np.array_equal(part[..., v], jt[..., v])
            assert not part[..., ~v].any()           # the port zero-fills
        any_col |= bool(jcol)
    assert bool(collided) and any_col
