"""The port's per-window MSM program (`msm.window_program`) and its bucket
helpers, with the plain versions of K4, K8, K3, K7 and K2 on the CPU,
against what the JAX package runs there: `_bucket_sums` and
`_bucket_sums_chunked` (XLA) and `_jit_window` (its XLA chunked route:
off the TPU the JAX package does not take the fused Pallas route).  K8 in
Pallas interpret mode is no yardstick here: one G1 call at n = 64 ran
over 170 s.  The collision case: a point repeated right after its
segment's start raises K8's flag in that lane, and the window still
returns the right buckets through the collision-safe route.

Tolerance: exact, as compressed golden points.  The K8 route's Jacobian
representatives may differ from the XLA route's, so limbs are not
compared."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FR

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

N, NB = 128, 9          # bucket tests: 4 chunks of K = 32, c = 4 signed


def _b(points):
    """Points of either package -> compressed bytes (the two packages'
    golden classes are their own)."""
    return [p.to_compressed_bytes() for p in points]


def _g1_points(n, seed):
    r = random.Random(seed)
    g = G1.generator()
    return [g * r.randrange(1, params.R) for _ in range(n)]


def _affine(pts):
    """Golden points -> (JAX affine batch, the port's affine batch)."""
    ja = CJ.to_affine(CJ.pack_g1(pts), CJ.FQ_OPS)
    return ja, C.from_jax(tuple(np.asarray(x) for x in ja))


_OPS, _INF = CJ.FQ_OPS, CJ.infinity_g1
_jax_bucket_sums = jax.jit(lambda p, d: jmsm._bucket_sums(
    CJ.affine_to_jac(p, _OPS), d, NB, _OPS, _INF))


@pytest.fixture(scope="module")
def buckets_case():
    """Bases with an infinity, random digits in [0, NB), and the JAX
    package's bucket sums of them (log-depth and chunked)."""
    pts = _g1_points(N - 1, 31) + [G1.zero()]
    digits = np.random.RandomState(31).randint(0, NB, size=N).astype(np.int32)
    ja, pa = _affine(pts)
    jd = jnp.asarray(digits)
    want_hs = _jax_bucket_sums(ja, jd)
    want_ch = jax.jit(lambda p, d: jmsm._bucket_sums_chunked(
        p, d, NB, _OPS, _INF))(ja, jd)
    return dict(pa=pa, digits=torch.from_numpy(digits),
                want_hs=_b(CJ.unpack_g1(want_hs)),
                want_ch=_b(CJ.unpack_g1(want_ch)))


def test_bucket_sums_fused_matches_jax_bucket_sums(buckets_case):
    """(K4, gather, plain K8, carry scatter) == the JAX log-depth and
    chunked bucket sums."""
    case = buckets_case
    before = msm.FALLBACKS["bucket_sums_fused"]
    got = _b(C.unpack_g1(msm._bucket_sums_fused(case["pa"], case["digits"],
                                                NB)))
    assert msm.FALLBACKS["bucket_sums_fused"] == before
    assert got == case["want_hs"] == case["want_ch"]


def test_bucket_sums_chunked_matches_jax(buckets_case):
    """The K3 loop of phase 1 and the carry scatter, affine bases."""
    case = buckets_case
    got = msm._bucket_sums_chunked(case["pa"], case["digits"], NB)
    assert _b(C.unpack_g1(got)) == case["want_ch"]


def test_bucket_sums_log_depth_matches_jax(buckets_case):
    case = buckets_case
    got = msm._bucket_sums(C.affine_to_jac(case["pa"]), case["digits"], NB)
    assert _b(C.unpack_g1(got)) == case["want_hs"]


@pytest.mark.parametrize("c,windows", [(4, (0, 3, 63)), (8, (3, 31))])
def test_window_program_matches_jax_jit_window(c, windows):
    """window_program(g1, c, affine=True) (the K8 route) against the JAX
    `_jit_window(g1, c, affine=True)` on signed digits.  c = 8 pads
    nb = 129 to 192 and takes the chunked reduce at K = 64."""
    n = 64
    r = random.Random(c)
    pts = _g1_points(n - 1, 40 + c) + [G1.zero()]
    scs = [r.randrange(params.R) for _ in range(n)]
    ja, pa = _affine(pts)
    dig = msm._scalars_to_signed_windows(F.pack(scs, FR), c)
    assert int(dig.min()) < 0
    run = msm.window_program("g1", c, affine=True)
    jrun = jmsm._jit_window("g1", c, affine=True)
    for w in windows:
        want = CJ.unpack_g1(jrun(ja, jnp.asarray(dig[w].numpy())))
        assert _b(C.unpack_g1(run(pa, dig[w]))) == _b(want)


def test_duplicate_points_raise_k8_flag_and_take_the_safe_route():
    """The two points of bucket NB - 1 are equal: after the sort they are
    the last two elements, in chunk 3, the first one a segment start, so
    K8's mixed add meets P + P in lane 3 only.  The fused bucket sums then
    take `_bucket_sums` and still equal the JAX package's."""
    pts = _g1_points(N, 32)
    digits = np.random.RandomState(32).randint(0, NB - 1, size=N).astype(
        np.int32)
    i, j = 20, 90
    pts[j] = pts[i]
    digits[i] = digits[j] = NB - 1
    ja, pa = _affine(pts)
    d = torch.from_numpy(digits)
    d_sorted, order = torch.sort(d, stable=True)
    sorted_pts = tuple(x[..., order] for x in pa)
    _scanned, flag = K.bucket_scan(sorted_pts, d_sorted, 32, "g1")
    assert flag.tolist() == [False, False, False, True]
    before = msm.FALLBACKS["bucket_sums_fused"]
    got = msm._bucket_sums_fused(pa, d, NB)
    assert msm.FALLBACKS["bucket_sums_fused"] == before + 1
    want = _jax_bucket_sums(ja, jnp.asarray(digits))
    assert _b(C.unpack_g1(got)) == _b(CJ.unpack_g1(want))
    assert _b(C.unpack_g1(got))[NB - 1] == _b([pts[i] + pts[i]])[0]
