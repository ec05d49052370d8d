"""The port's bindings of its host library (`zukelang_tpu_torch/native.py`
over `hostsrc/zukelang_native.cpp`), with the cases of the JAX package's
`tests/test_native.py`, against the port's golden oracle: the Fr batch
products and inverses, G1 scalar multiplication and MSM (edge scalars
and an infinity base included) and the pairing; beyond them, the G2
addition and scalar multiplication and the Groth16 proof assembly,
against the golden group law and the golden assembly's expression, on
random points and at the edges (infinity operands, P + P, P + (-P),
scalars 0, 1 and r - 1, outputs at infinity).  The JAX package's
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


def _g2_add_case(case):
    r = random.Random(23)
    g2 = G2.generator()
    p, q = g2 * r.randrange(1, params.R), g2 * r.randrange(1, params.R)
    return {"random": (p, q), "p_plus_p": (p, p), "p_plus_minus_p": (p, -p),
            "infinity_left": (G2.zero(), p), "infinity_right": (p, G2.zero()),
            "infinity_both": (G2.zero(), G2.zero())}[case]


@pytest.mark.parametrize("case", ["random", "p_plus_p", "p_plus_minus_p",
                                  "infinity_left", "infinity_right",
                                  "infinity_both"])
def test_g2_add_matches_golden(case):
    p, q = _g2_add_case(case)
    assert native.g2_add(p, q) == p + q


@pytest.mark.parametrize("k", [0, 1, 2, params.R - 1, 0xdeadbeef,
                               "random", "infinity_base"])
def test_g2_scalar_mul_matches_golden(k):
    r = random.Random(29)
    p = G2.generator() * r.randrange(1, params.R)
    if k == "infinity_base":
        p, k = G2.zero(), r.randrange(params.R)
    elif k == "random":
        k = r.randrange(params.R)
    assert native.g2_scalar_mul(p, Fr(k)) == p * k


def _golden_assembly(alpha1, beta1, delta1, beta2, delta2, A, B1, H, Cmid, B,
                     r, s):
    """The expression the Groth16 provers assembled on golden points."""
    a = alpha1 + A + delta1 * r
    b = beta2 + B + delta2 * s
    b1 = beta1 + B1 + delta1 * s
    c = Cmid + H + a * s + b1 * r - delta1 * (r * s)
    return a, b, c


ASSEMBLY_CASES = ["random", "msm_sum_a_infinity", "msm_sums_all_infinity",
                  "r_zero", "s_zero", "r_one", "s_one", "r_minus_one",
                  "a_infinity", "b_infinity", "b1_infinity",
                  "beta_plus_b1_infinity", "h_equals_cmid",
                  "h_equals_minus_cmid", "c_last_add_doubles",
                  "c_infinity"]


def _assembly_inputs(case):
    rnd = random.Random(31)
    g1, g2 = G1.generator(), G2.generator()
    alpha1, beta1, delta1, A, B1, H, Cmid = (
        g1 * rnd.randrange(1, params.R) for _ in range(7))
    beta2, delta2, B = (g2 * rnd.randrange(1, params.R) for _ in range(3))
    r, s = (Fr(rnd.randrange(params.R)) for _ in range(2))
    if case == "msm_sum_a_infinity":
        A = G1.zero()
    elif case == "msm_sums_all_infinity":
        A = B1 = H = Cmid = G1.zero()
        B = G2.zero()
    elif case in ("r_zero", "s_zero", "r_one", "s_one", "r_minus_one"):
        k = {"zero": 0, "one": 1, "minus_one": params.R - 1}[
            case.split("_", 1)[1]]
        r, s = (Fr(k), s) if case.startswith("r") else (r, Fr(k))
    elif case == "a_infinity":
        A = -(alpha1 + delta1 * r)
    elif case == "b_infinity":
        B = -(beta2 + delta2 * s)
    elif case == "b1_infinity":
        B1 = -(beta1 + delta1 * s)
    elif case == "beta_plus_b1_infinity":
        B1 = -beta1
    elif case == "h_equals_cmid":
        H = Cmid
    elif case == "h_equals_minus_cmid":
        H = -Cmid
    elif case in ("c_last_add_doubles", "c_infinity"):
        # the products' sum a s + b1 r - delta r s, then Cmid + H set to it
        # (its last addition is P + P) or to its negation (P + (-P))
        a = alpha1 + A + delta1 * r
        b1 = beta1 + B1 + delta1 * s
        tail = a * s + b1 * r - delta1 * (r * s)
        Cmid = (tail if case == "c_last_add_doubles" else -tail) - H
    return alpha1, beta1, delta1, beta2, delta2, A, B1, H, Cmid, B, r, s


@pytest.mark.parametrize("case", ASSEMBLY_CASES)
def test_groth16_assemble_matches_golden(case):
    args = _assembly_inputs(case)
    want = _golden_assembly(*args)
    assert native.groth16_assemble(*args) == want
    if case == "a_infinity":
        assert want[0].is_zero()
    if case == "b_infinity":
        assert want[1].is_zero()
    if case == "c_infinity":
        assert want[2].is_zero()
