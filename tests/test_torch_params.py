"""The port's own copies of what it took from the JAX package: the curve
constants and the limb-32 Montgomery constants (params), the rng streams,
the golden encodings and the keypair JSON helpers, and its pairing (the
native library it builds, against its golden pairing and the JAX
package's).

Tolerance: exact (ints, bytes)."""

import random

import pytest

from zukelang_tpu import params as jparams
from zukelang_tpu import serialize as jser
from zukelang_tpu.golden.curve import G1 as JG1, G2 as JG2
from zukelang_tpu.pairing import pairing as jpairing
from zukelang_tpu.rng import Gen as JGen, InjectedRng as JInjectedRng
from zukelang_tpu_torch import pairing, params, rng, serialize
from zukelang_tpu_torch.golden.curve import G1, G2

CURVE = ("P", "R", "BLS_X", "BLS_X_IS_NEG", "B_G1", "B_G2", "G1_GEN_X",
         "G1_GEN_Y", "G2_GEN_X", "G2_GEN_Y", "FR_TWO_ADICITY",
         "FR_GENERATOR", "FR_ROOT_OF_UNITY")


@pytest.mark.parametrize("name", CURVE)
def test_curve_constants_equal_the_jax_package(name):
    assert getattr(params, name) == getattr(jparams, name)


def test_montgomery_constants_match_the_jax_layout():
    """Same radix as the JAX package's 16-bit limbs (so Montgomery forms
    repack bit for bit); -p^-1 agrees with its 16-bit one modulo 2^16."""
    for spec, jr, jnp_, p in ((params.FR, jparams.FR_MONT_R,
                               jparams.FR_NPRIME, jparams.R),
                              (params.FQ, jparams.FQ_MONT_R,
                               jparams.FQ_NPRIME, jparams.P)):
        assert spec.p == p and spec.R == jr
        assert spec.nprime & 0xFFFF == jnp_
        assert spec.r_mod_p == jr % p and spec.r2_mod_p == jr * jr % p


def test_rng_streams_equal_the_jax_package():
    for seed in (3, b"bench-keygen", b"bench-pin-prove"):
        a, b = rng.Gen(seed), JGen(seed)
        for _ in range(4):
            assert a.fr().n == b.fr().n
        assert [a._draw() for _ in range(3)] == [b._draw() for _ in range(3)]
        assert (a.bool(), a.uint32(), a.int(97)) == (b.bool(), b.uint32(),
                                                    b.int(97))
    inj, jinj = rng.InjectedRng([5, 6]), JInjectedRng([5, 6])
    assert [inj.fr().n, inj.fr().n] == [jinj.fr().n, jinj.fr().n]
    with pytest.raises(RuntimeError):
        inj.fr()


def test_point_encodings_and_json_equal_the_jax_package():
    r = random.Random(5)
    for cls, jcls in ((G1, JG1), (G2, JG2)):
        for k in (0, 1, r.randrange(jparams.R)):
            p, jp = cls.generator() * k, jcls.generator() * k
            assert p.to_compressed_bytes() == jp.to_compressed_bytes()
            assert cls.of_compressed_bytes(jp.to_compressed_bytes()) == p
    g, h = G1.generator() * 3, G2.generator() * 4
    jg, jh = JG1.generator() * 3, JG2.generator() * 4
    assert serialize.g1_to_json(g) == jser.g1_to_json(jg)
    assert serialize.g2_to_json(h) == jser.g2_to_json(jh)
    assert serialize.g2_of_json(jser.g2_to_json(jh)) == h
    gt = pairing.pairing(g, h)
    assert serialize.gt_to_json(gt) == jser.gt_to_json(jpairing(jg, jh))
    assert serialize.gt_of_json(serialize.gt_to_json(gt)) == gt
    f = rng.Gen(1).fr()
    assert serialize.fr_to_json(f) == jser.fr_to_json(JGen(1).fr())
    assert serialize.fr_of_json(serialize.fr_to_json(f)) == f


def test_native_pairing_equals_golden_and_is_bilinear():
    g, h = G1.generator(), G2.generator()
    e = pairing.pairing(g * 6, h * 7)
    assert e == pairing.pairing(g * 6, h * 7, backend="golden")
    assert e == pairing.pairing(g, h) * 42
    assert pairing.multi_pairing([(g * 2, h), (g, h * 3)]) == pairing.pairing(
        g, h) * 5
    assert pairing.pairing(G1.zero(), h) == pairing.pairing(g, G2.zero())
    with pytest.raises(ValueError):
        pairing.pairing(g, h, backend="other")
