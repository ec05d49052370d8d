"""The port's MSM kernels: the plain versions of K4, K5, K7 and K6 against
what the JAX package runs in their place on the CPU (the interpret-mode
bitonic sort, the XLA bucket sums and scans), and against the golden
curve; the digit helpers against the JAX package's; one v2 MSM at
n = 128 with negative digits.  The rest of the pipeline is in
test_torch_msm_pipeline.py.

Tolerance: exact — sorted keys and permutations equal, limbs equal where
the order is fixed, points equal as golden affine points."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1
from zukelang_tpu.golden.field import Fr
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu.ops import pallas_kernels as PK
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FR

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

rng = random.Random(17)


def _g1_points(n, seed):
    r = random.Random(seed)
    g = G1.generator()
    return [g * r.randrange(1, params.R) for _ in range(n)]


def _b(points):
    """Points of either package -> their compressed bytes: the port's
    classes are its own, so points compare across packages by encoding."""
    return [p.to_compressed_bytes() for p in points]


def test_digit_sort_plain_is_a_stable_argsort():
    keys = torch.from_numpy(np.random.RandomState(0).randint(
        0, 4097, size=(3, 4096)).astype(np.int32))
    sk, order = K.digit_sort(keys, 4097)
    assert order.dtype == torch.int32
    for r in range(3):
        want = np.argsort(keys[r].numpy(), kind="stable")
        assert np.array_equal(order[r].numpy(), want)
        assert torch.equal(keys[r][order[r].long()], sk[r])
    assert K.LAUNCHES["digit_sort"] == 0


@pytest.mark.parametrize("n", [256, 2048])
def test_digit_sort_plain_matches_bitonic_argsort_interpret(n):
    """K4 against the Pallas bitonic sort it replaces, in interpret mode.
    The bitonic sort is unstable: the sorted keys are equal, and each
    order is a permutation that sorts the keys."""
    keys = np.random.RandomState(n).randint(0, 17, size=n).astype(np.int32)
    jsk, jorder = (np.asarray(x) for x in
                   PK.bitonic_argsort(jnp.asarray(keys), interpret=True))
    sk, order = K.digit_sort(torch.from_numpy(keys)[None], 17)
    order = order[0].numpy()
    assert np.array_equal(sk[0].numpy(), jsk)
    for o in (order, jorder):
        assert np.array_equal(np.sort(o), np.arange(n))
        assert np.array_equal(keys[o], jsk)


@pytest.mark.parametrize("segmented", [False, True])
def test_k7_scans_match_jax_xla_scans(segmented):
    """The port's K7 chunk scan with its cross-chunk carries, and the K7
    total, against the JAX package's CPU path (the XLA log-depth scans).
    Segments of 24 cross the chunk boundaries of 32."""
    n = 128
    pts = _g1_points(n, 8)
    pts[3] = G1.zero()
    seg = (np.arange(n) // 24 if segmented else np.zeros(n)).astype(np.int32)
    P, JP = C.pack_g1(pts), CJ.pack_g1(pts)
    got = msm._seg_scan_auto(P, torch.from_numpy(seg))
    want = jax.jit(lambda p, s: jmsm._seg_scan_auto(p, s, CJ.FQ_OPS))(
        JP, jnp.asarray(seg))
    assert _b(C.unpack_g1(got)) == _b(CJ.unpack_g1(want))
    if not segmented:
        want_total = jax.jit(lambda p: jmsm._total_auto(p, CJ.FQ_OPS))(JP)
        assert _b(C.unpack_g1(msm._total_auto(P))) == _b(CJ.unpack_g1(want_total))


def test_bucket_scan_rows_matches_carry_scatter_and_bucket_sums():
    """K5 (plain) + the JAX carry application == the JAX log-depth bucket
    sums, as tests/test_pallas_tpu.py pairs them for the Pallas kernel."""
    n, Kc, nb = 128, 32, 9
    pts = _g1_points(n - 1, 1) + [G1.zero()]
    Paff = CJ.to_affine(CJ.pack_g1(pts), CJ.FQ_OPS)
    digits = np.random.RandomState(1).randint(0, nb, size=n).astype(np.int32)
    order = np.argsort(digits, kind="stable")
    d_sorted = digits[order]
    psort = tuple(x[..., order] for x in Paff)
    tx, ty = C.from_jax(tuple(np.asarray(x) for x in psort))
    M = n // Kc
    pts3 = torch.cat([tx, ty]).reshape(24, M, Kc).permute(2, 0, 1).contiguous()
    seg3 = torch.from_numpy(d_sorted).reshape(M, Kc).t()[:, None, :].contiguous()
    segp3 = torch.cat([seg3[:1], seg3[:-1]])
    scanned3, collided = K.bucket_scan_rows(pts3, seg3, segp3, "g1")
    assert not bool(collided.any())
    flat = tuple(v.permute(1, 2, 0).reshape(12, n) for v in scanned3)
    scanned = tuple(jnp.asarray(a) for a in C.to_jax(flat))
    got = jax.jit(lambda s, d: jmsm._carry_scatter(
        s, d, nb, CJ.FQ_OPS, CJ.infinity_g1, Kc))(scanned, jnp.asarray(d_sorted))
    ref = jax.jit(lambda p, d: jmsm._bucket_sums(
        CJ.affine_to_jac(p, CJ.FQ_OPS), d, nb, CJ.FQ_OPS, CJ.infinity_g1))(
        psort, jnp.asarray(d_sorted))
    assert CJ.unpack_g1(got) == CJ.unpack_g1(ref)
    # tails_only keeps exactly the last step of every lane
    tails, _ = K.bucket_scan_rows(pts3, seg3, segp3, "g1", tails_only=True)
    assert all(torch.equal(t[0], s[-1]) for t, s in zip(tails, scanned3))


def test_jac_scan_plain_matches_golden_prefix_sums():
    n, Kc = 64, 32
    pts = _g1_points(n, 2)
    pts[5] = G1.zero()
    seg = np.repeat(np.arange(8), 8).astype(np.int32)
    for s in (None, seg):
        got = C.unpack_g1(K.jac_scan(C.pack_g1(pts), Kc,
                                     None if s is None else torch.from_numpy(s)))
        want = []
        for lane in range(n // Kc):
            acc = G1.zero()
            for t in range(Kc):
                i = lane * Kc + t
                if t and s is not None and s[i] != s[i - 1]:
                    acc = G1.zero()
                acc = acc + pts[i]
                want.append(acc)
        assert _b(got) == _b(want)


def test_weighted_chunk_sums_plain_matches_golden():
    """The JAX package has no XLA form of K6 (its CPU path is the Pallas
    kernel in interpret mode, minutes even at n = 64): golden sums."""
    n, Kc = 64, 32
    pts = _g1_points(n, 3)
    pts[40] = G1.zero()
    s, w = K.weighted_chunk_sums(C.pack_g1(pts), Kc)
    for m, (sg, wg) in enumerate(zip(C.unpack_g1(s), C.unpack_g1(w))):
        chunk = pts[m * Kc:(m + 1) * Kc]
        assert _b([sg, wg]) == _b([G1.sum(chunk),
                                   G1.dot(chunk, [Fr(t) for t in range(Kc)])])


@pytest.mark.parametrize("c", [4, 5])
def test_signed_windows_match_jax(c):
    scs = [0, 1, params.R - 1] + [rng.randrange(params.R) for _ in range(5)]
    want = np.asarray(jmsm._scalars_to_signed_windows(FJ.pack(scs, FJ.FR), c))
    got = msm._scalars_to_signed_windows(F.pack(scs, FR), c)
    assert np.array_equal(got.numpy(), want)
    assert msm.auto_window(1 << 16) == jmsm.auto_window(1 << 16) == 13


def test_msm_g1_v2_n128_negative_digits_matches_golden():
    n = 128
    pts = _g1_points(n, 6)
    scs = [params.R - 1 - i for i in range(n)]          # dense top bits
    res = msm.msm_staged_deferred(C.to_affine(C.pack_g1(pts)),
                                  F.pack(scs, FR), group="g1", c=5)()
    assert _b(C.unpack_g1(res)) == _b([G1.dot(pts, [Fr(s) for s in scs])])
