"""The port's bindings of its host library (`zukelang_tpu_torch/native.py`
over `hostsrc/zukelang_native.cpp`), with the cases of the JAX package's
`tests/test_native.py`, against the port's golden oracle: the Fr batch
products and inverses, G1 scalar multiplication and MSM (edge scalars
and an infinity base included) and the pairing.  The JAX package's
`native` module is not loaded here: it rebuilds its library in place in
the repository tree.  A library that cannot be built raises from
`library()` and from every binding; none returns None.

Tolerance: exact."""

import random

import pytest

from zukelang_tpu_torch import native, params
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.golden.pairing import multi_pairing, pairing


def test_fr_batches():
    r = random.Random(17)
    a = [Fr(r.randrange(params.R)) for _ in range(50)]
    b = [Fr(r.randrange(params.R)) for _ in range(50)]
    assert native.fr_mul_batch(a, b) == [x * y for x, y in zip(a, b)]
    assert native.fr_inv_batch(a) == [x.inv() for x in a]
    assert native.fr_inv_batch([Fr(0)]) == [Fr(0)]
    with pytest.raises(ValueError):
        native.fr_mul_batch(a, b[:-1])


def test_g1_scalar_mul():
    g = G1.generator()
    for k in (0, 1, 2, params.R - 1, 123456789):
        assert native.g1_scalar_mul(g, Fr(k)) == g * k
    assert native.g1_scalar_mul(G1.zero(), Fr(5)) == G1.zero()


def test_g1_msm_matches_golden():
    r = random.Random(17)
    g = G1.generator()
    pts = [g * r.randrange(1, 10 ** 9) for _ in range(40)] + [G1.zero()]
    scs = [Fr(r.randrange(params.R)) for _ in range(41)]
    assert native.g1_msm(pts, scs) == G1.dot(pts, scs)


def test_g1_msm_edge_scalars():
    g = G1.generator()
    pts = [g, g * 2, g * 3]
    scs = [Fr(0), Fr(1), Fr(params.R - 1)]
    assert native.g1_msm(pts, scs) == G1.dot(pts, scs)
    assert native.g1_msm([g, g], [Fr(3), Fr(3)]) == g * 6   # equal terms


def test_pairing_matches_golden():
    r = random.Random(5)
    g1, g2 = G1.generator(), G2.generator()
    cases = [(g1, g2), (g1 * 7, g2 * 3), (G1.zero(), g2), (g1, G2.zero()),
             (g1 * r.randrange(1 << 64), g2 * r.randrange(1 << 64))]
    for p, q in cases:
        assert native.gt_pairing(p, q) == pairing(p, q)
    assert native.gt_multi_pairing(cases) == multi_pairing(cases)
    assert native.gt_pairing(g1 * 6, g2 * 11) == native.gt_pairing(g1 * 66, g2)


def test_a_library_that_cannot_be_built_raises(monkeypatch, tmp_path):
    """CXX names a compiler that is missing, in a fresh build directory:
    `library()` raises, and so does a binding; nothing returns None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.library()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.fr_inv_batch([Fr(2)])
    assert native._lib is None
