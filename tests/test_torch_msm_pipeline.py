"""The port's v2 Pippenger pipeline and fixed-base batches (plain
versions of K1, K2, K4-K7 on the CPU) against golden G1.dot / G2.dot and
golden scalar multiples, with negative digits and a real collision that
takes the safe re-dispatch.

Tolerance: exact equality of golden affine points (the digit sort's tie
order is free, so Jacobian representations are not compared)."""

import random

import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1, G2
from zukelang_tpu.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FR

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

rng = random.Random(19)


def _g1_points(n, seed):
    r = random.Random(seed)
    g = G1.generator()
    return [g * r.randrange(1, params.R) for _ in range(n)]


def _b(points):
    """Points of either package -> their compressed bytes: the port's
    classes are its own, so points compare across packages by encoding."""
    return [p.to_compressed_bytes() for p in points]


def test_msm_many_v2_matches_golden():
    n = 64
    t1 = _g1_points(n - 1, 4) + [G1.zero()]
    t2 = [G1.generator() * (2 * i + 5) for i in range(n)]
    s1 = [rng.randrange(params.R) for _ in range(n)]
    s2 = [(1 << (5 * (i % 50 + 1))) - 1 for i in range(n)]  # negative digits
    T1, T2 = C.to_affine(C.pack_g1(t1)), C.to_affine(C.pack_g1(t2))
    resolve = msm.msm_many_staged_deferred(
        (T1, T2), [F.pack_mont(s1, FR), F.pack_mont(s2, FR)], pmap=(0, 1),
        group="g1", c=4)
    got = C.unpack_g1(resolve())
    assert _b(got) == _b([G1.dot(t1, [Fr(s) for s in s1]),
                          G1.dot(t2, [Fr(s) for s in s2])])


def test_msm_g2_v2_matches_golden():
    n = 64
    g2 = G2.generator()
    pts = [g2 * rng.randrange(1, params.R) for _ in range(n)]
    scs = [rng.randrange(params.R) for _ in range(n)]
    res = msm.msm_staged_deferred(C.to_affine(C.pack_g2(pts)),
                                  F.pack(scs, FR), group="g2", c=5)()
    assert _b(C.unpack_g2(res)) == _b([G2.dot(pts, [Fr(s) for s in scs])])


def test_msm_collision_takes_the_safe_redispatch(monkeypatch):
    """Equal points in one bucket make K5's mixed add hit the doubling
    case; resolve() must see the flag and re-run the safe path."""
    n = 64
    g = G1.generator()
    pts = [g * 5] * n
    calls = []
    real_safe = msm._msm_safe_impl

    def spy(*a, **kw):
        calls.append(1)
        return real_safe(*a, **kw)

    monkeypatch.setattr(msm, "_msm_safe_impl", spy)
    res = msm.msm_staged_deferred(C.to_affine(C.pack_g1(pts)),
                                  F.pack([7] * n, FR), group="g1", c=6)()
    assert calls == [1]
    assert _b(C.unpack_g1(res)) == _b([g * (5 * 7 * n)])


def test_msm_rejects_widths_off_the_v2_path():
    T = C.to_affine(C.pack_g1(_g1_points(32, 5)))
    with pytest.raises(ValueError):
        msm.msm_staged_deferred(T, F.pack([1] * 32, FR), group="g1", c=4)


def test_fixed_base_mul_matches_golden():
    scs = [0, 1, 2, params.R - 1] + [rng.randrange(params.R) for _ in range(12)]
    out = msm.fixed_base_mul(F.pack(scs, FR), "g1", c=4)
    assert out[0].shape[-1] == len(scs)
    assert _b(C.unpack_g1(out)) == _b([G1.generator() * Fr(s) for s in scs])


@pytest.mark.parametrize("group,n", [("g2", 16), ("g1", 128)])
def test_fixed_base_mul_both_paths_match_golden(group, n):
    """Below 128 elements the window loop of K3 mixed adds (here G2),
    from 128 the K5 rows path; both against golden scalar multiples."""
    gen = (G1 if group == "g1" else G2).generator()
    scs = [0, 1, params.R - 1] + [rng.randrange(params.R) for _ in range(n - 3)]
    out = msm.fixed_base_mul(F.pack(scs, FR), group, c=4)
    assert out[0].shape[-1] == n
    unpack = C.unpack_g1 if group == "g1" else C.unpack_g2
    assert _b(unpack(out)) == _b([gen * Fr(s) for s in scs])
