"""The plain reference: the curve, the Lagrange values, and a judge that
catches a wrong point."""

import random

import pytest

from zkbench import generator
from zkbench.reference import bls12_381 as bls
from zkbench.reference import groth16 as ref_mod

R = bls.R


@pytest.fixture(scope="module")
def bases():
    return bls.g1_base(), bls.g2_base()


def test_generators_and_order(bases):
    g1, g2 = bases
    assert bls.on_curve(bls.Fq, 4, (bls.G1_X, bls.G1_Y))
    assert bls.on_curve(bls.Fq2, (4, 4), (bls.G2_X, bls.G2_Y))
    assert g1.mul(1) == (bls.G1_X, bls.G1_Y)
    assert g1.mul(R) is None and g2.mul(R) is None and g1.mul(0) is None
    assert g1.mul(R - 1) == (bls.G1_X, (-bls.G1_Y) % bls.P)


@pytest.mark.parametrize("seed", [1, 2])
def test_fixed_base_is_linear(bases, seed):
    rnd = random.Random(seed)
    for base, F in zip(bases, (bls.Fq, bls.Fq2)):
        a, b = rnd.randrange(R), rnd.randrange(R)
        pa, pb = base.mul(a), base.mul(b)
        assert bls.add(F, pa, pb) == base.mul(a + b)
        assert bls.add(F, pa, pa) == base.mul(2 * a)
        assert bls.on_curve(F, (4, 4) if F is bls.Fq2 else 4, pa)


def test_batch_inverse_and_lagrange():
    xs = [3, 5, R - 1, 12345678901234567890]
    assert [x * y % R for x, y in zip(xs, ref_mod.batch_inverse(xs))] == [
        1] * 4
    w = ref_mod.root_of_unity(4, 5, 32)
    assert pow(w, 16, R) == 1 and pow(w, 8, R) != 1
    lag = ref_mod.lagrange_at(987654321, 4, 16, w)
    assert sum(lag) % R == 1              # the L_g sum to 1
    x = 4242
    vals = [pow(w, g, R) for g in range(16)]
    lag_x = ref_mod.lagrange_at(x, 4, 16, w)
    assert sum(l * v for l, v in zip(lag_x, vals)) % R == x


def test_judge_catches_a_wrong_point():
    conf = {"gates": 16, "domain_log": 4}
    inst = generator.build(conf, {"witnesses": 2},
                           5)
    ref = ref_mod.Groth16Reference(inst.gates, inst.witnesses, inst.ios,
                                   inst.logn, inst.trapdoor, 5, 32)
    sc = inst.proof_scalars()
    proofs = []
    for i in range(4):
        r, s = next(sc)
        msm = ref.msm_points(i % 2)
        sca = ref.scalars(i % 2)
        z = pow(ref.z_tau, -1, R)
        proofs.append({"widx": i % 2, "r": r, "s": s,
                       "proof": ref.proof_points(i % 2, r, s),
                       "g1": list(reversed(msm["g1"])), "g2": msm["g2"],
                       "reduction": (sca["A"], sca["B"],
                                     (sca["A"] * sca["B"] - sca["C"]) * z % R,
                                     0)})
    good = ref_mod.judge(ref, proofs)
    assert good == {"proofs": 4, "failed": 0, "proof_mismatch": 0,
                    "msm_mismatch": 0, "reduction_checked": 4,
                    "reduction_mismatch": 0}
    g = bls.g1_base()
    proofs[1]["proof"] = (bls.add(bls.Fq, proofs[1]["proof"][0], g.mul(1)),
                          *proofs[1]["proof"][1:])
    proofs[2]["g1"] = proofs[2]["g1"][:3]
    a, b, h, top = proofs[3]["reduction"]
    proofs[3]["reduction"] = (a, b, h, 1)
    bad = ref_mod.judge(ref, proofs)
    assert bad["proof_mismatch"] == 1 and bad["msm_mismatch"] == 1
    assert bad["reduction_mismatch"] == 1 and bad["failed"] == 3


def test_mont_values():
    import numpy as np
    x = (1 << 255) + 12345
    limbs = np.array([[(x >> (32 * i)) & 0xFFFFFFFF] for i in range(8)],
                     dtype=np.uint32)
    assert ref_mod.mont_values(limbs) == [x]
