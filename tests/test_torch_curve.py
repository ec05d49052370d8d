"""The port's curve layer (K2's plain versions, to_affine, packing)
against the JAX package's curve_jax and the golden curve, G1 and G2,
with the special cases: P + P, P + (-P) and infinity operands.

Tolerance: integer limbs, exact equality after repacking; golden points
by equality."""

import random

import jax
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1, G2
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import kernels as K

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

GROUPS = {
    "g1": (G1, CJ.FQ_OPS, CJ.pack_g1, C.pack_g1, C.unpack_g1),
    "g2": (G2, CJ.FQ2_OPS, CJ.pack_g2, C.pack_g2, C.unpack_g2),
}


def _cases(group, seed):
    """Operand lists covering generic lanes and every special case."""
    gcls = GROUPS[group][0]
    g = gcls.generator()
    rng = random.Random(seed)
    ks = [rng.randrange(1, params.R) for _ in range(4)]
    ps = [g * k for k in ks]
    qs = [g * rng.randrange(1, params.R) for _ in range(4)]
    ps += [g * 7, g * 9, gcls.zero(), g * 3, gcls.zero()]
    qs += [g * 7, -(g * 9), g * 5, gcls.zero(), gcls.zero()]
    return ps, qs


def _jax_pts(pts):
    return tuple(np.asarray(x) for x in pts)


def _b(points):
    """Points of either package -> their compressed bytes: the port's
    classes are its own, so points compare across packages by encoding."""
    return [p.to_compressed_bytes() for p in points]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_double_match_curve_jax_and_golden(group):
    _gcls, ops, jpack, tpack, unpack = GROUPS[group]
    ps, qs = _cases(group, 1)
    jP, jQ = jpack(ps), jpack(qs)
    tP, tQ = C.from_jax(_jax_pts(jP)), C.from_jax(_jax_pts(jQ))
    assert all(torch.equal(a, b) for a, b in zip(tP, tpack(ps)))

    got = K.point_add_plain(tP, tQ)
    want = jax.jit(lambda p, q: CJ.point_add(p, q, ops))(jP, jQ)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(got), want))
    assert _b(unpack(got)) == _b([a + b for a, b in zip(ps, qs)])

    dbl = K.point_double_plain(tP)
    want = jax.jit(lambda p: CJ.point_double(p, ops))(jP)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(dbl), want))
    assert _b(unpack(dbl)) == _b([a.double() for a in ps])
    assert K.LAUNCHES["point_add"] == K.LAUNCHES["point_double"] == 0


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_matches_curve_jax(group):
    _gcls, ops, jpack, tpack, unpack = GROUPS[group]
    ps, qs = _cases(group, 2)
    # Jacobian inputs with Z != 1: sums of two points
    jac = K.point_add_plain(tpack(ps), tpack(qs))
    want = jax.jit(lambda p: CJ.to_affine(p, ops))(
        tuple(jax.numpy.asarray(x) for x in C.to_jax(jac)))
    got = C.to_affine(jac)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(got), want))
    assert _b(unpack(C.affine_to_jac(got))) == _b([a + b for a, b in zip(ps, qs)])
    # infinity is exactly (0, 0)
    assert not got[0][..., -1].any() and not got[1][..., -1].any()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_madd_and_neg_match_golden(group):
    _gcls, _ops, _jpack, tpack, unpack = GROUPS[group]
    ps, qs = _cases(group, 3)
    got = C.point_madd(tpack(ps), C.to_affine(tpack(qs)))
    assert _b(unpack(got)) == _b([a + b for a, b in zip(ps, qs)])
    assert _b(unpack(C.point_neg(tpack(ps)))) == _b([-a for a in ps])


def test_kernel_madd_flags_only_the_doubling_lane():
    g = G1.generator()
    ps = [g * 11, g * 4, G1.zero(), g * 7, -(g * 9)]
    qs = [g * 3, G1.zero(), g * 5, g * 7, g * 9]
    o = K.FieldOps("g1", K.mont_mul_plain)
    X3, Y3, Z3, same = K._madd(C.pack_g1(ps), C.to_affine(C.pack_g1(qs)), o)
    assert same.tolist() == [False, False, False, True, False]
    got = C.unpack_g1((X3, Y3, Z3))
    for i, (a, b) in enumerate(zip(ps, qs)):
        if i != 3:
            assert _b([got[i]]) == _b([a + b])


def _jax_madd_core(group, P, Qa):
    """The Pallas K3 body (`pallas_kernels._madd_core`) run as plain jnp on
    JAX-layout batches; returns (X3, Y3, Z3) JAX arrays and the flag."""
    import jax.numpy as jnp
    from zukelang_tpu.ops import field_jax as FJ
    from zukelang_tpu.ops import pallas_kernels as PK
    spec = FJ.FQ
    nl = spec.nl
    p_limbs = tuple(int(x) for x in spec.p_limbs)
    one_limbs = [int(x) for x in FJ._int_to_limbs(spec.r_mod_p, nl)]
    if group == "g1":
        rows = lambda a: [jnp.asarray(a)[j] for j in range(nl)]
        mul = lambda a, b: PK._fq_mul_body(a, b, p_limbs, spec.nprime)
        add = lambda a, b: PK._fq_add_body(a, b, p_limbs)
        sub = lambda a, b: PK._fq_sub_body(a, b, p_limbs)
        is_zero, sel, stack = PK._fq_is_zero_body, PK._select_limbs, jnp.stack
        like = rows(P[0])[0]
        one = [jnp.full_like(like, jnp.uint32(v)) for v in one_limbs]
    else:
        rows = lambda a: ([jnp.asarray(a)[0, j] for j in range(nl)],
                          [jnp.asarray(a)[1, j] for j in range(nl)])
        mul = lambda a, b: PK._fq2_mul_body(a, b, p_limbs, spec.nprime)
        add = lambda a, b: PK._fq2_add_body(a, b, p_limbs)
        sub = lambda a, b: PK._fq2_sub_body(a, b, p_limbs)
        is_zero, sel = PK._fq2_is_zero_body, PK._sel2
        stack = lambda v: jnp.stack([jnp.stack(v[0]), jnp.stack(v[1])])
        like = rows(P[0])[0][0]
        one = ([jnp.full_like(like, jnp.uint32(v)) for v in one_limbs],
               [jnp.zeros_like(like)] * nl)
    X3, Y3, Z3, same = PK._madd_core(*(rows(a) for a in (*P, *Qa)), mul, add,
                                     sub, is_zero, sel, one)
    return tuple(np.asarray(stack(v)) for v in (X3, Y3, Z3)), np.asarray(same)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_madd_plain_matches_pallas_madd_core(group):
    """K3's plain version against the Pallas kernel body, every lane
    bit-equal after repacking, the doubling lane's garbage and its flag
    included; then `ops.curve.point_madd` (K3 + K2 fix-up) against golden.
    Lanes: generic, q = infinity, p = infinity, p == q, p == -q, both
    infinity."""
    gcls, _ops, jpack, tpack, unpack = GROUPS[group]
    g = gcls.generator()
    ps = [g * 11, g * 4, gcls.zero(), g * 7, -(g * 9), gcls.zero(), g * 13]
    qs = [g * 3, gcls.zero(), g * 5, g * 7, g * 9, gcls.zero(), g * 2]
    # Jacobian p with Z != 1 in the generic lanes: p = p' + p'' packed
    P = K.point_add_plain(tpack([a - g for a in ps]), tpack([g] * len(ps)))
    Qa = C.to_affine(tpack(qs))
    (X3, Y3, Z3), same = K.point_madd_plain(P, Qa)
    want, wsame = _jax_madd_core(group, C.to_jax(P), C.to_jax(Qa))
    assert same.tolist() == wsame.tolist() == [False, False, False, True,
                                               False, False, False]
    for got, w in zip(C.to_jax((X3, Y3, Z3)), want):
        assert np.array_equal(got, w)
    sums = [a + b for a, b in zip(ps, qs)]
    got = unpack((X3, Y3, Z3))
    assert _b([got[i] for i in range(7) if i != 3]) == _b(
        [sums[i] for i in range(7) if i != 3])
    assert _b(unpack(C.point_madd(P, Qa))) == _b(sums)
    assert K.LAUNCHES["point_madd"] == 0


def test_infinity_and_repack_of_point_batches():
    inf1 = C.infinity_g1(3)
    inf2 = C.infinity_g2(2)
    assert _b(C.unpack_g1(inf1)) == _b([G1.zero()] * 3)
    assert _b(C.unpack_g2(inf2)) == _b([G2.zero()] * 2)
    j = CJ.infinity_g2(2)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(C.to_jax(inf2), j))
