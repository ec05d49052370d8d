"""The msm_roofline count against hand counts."""

from zkbench import costs


def test_constants():
    assert costs.FQ_LIMB_PRODUCTS == 288           # CIOS, 12 limbs
    assert costs.ADD_LIMB_PRODUCTS == {"g1": 3168, "g2": 9504}


def test_tiny_by_hand():
    # n = 4: c = 1: 5 x 256 = 1280; c = 2: 6 x 128 = 768; c = 3: 8 x 86 =
    # 688; c = 4: 12 x 64 = 768 -> c = 3, 688 additions
    assert costs.additions(4, 3) == 688
    assert costs.best_window(4) == (3, 688)
    assert costs.msm_limb_products({"g1": [4], "g2": [4]}) == \
        688 * (3168 + 9504)
    assert costs.msm_limb_products({"g1": [4, 4]}) == 2 * 688 * 3168


def test_2p20_and_2p16():
    assert costs.best_window(1 << 20) == (16, 16 * ((1 << 20) + (1 << 15)))
    assert costs.best_window(1 << 16)[0] == 13
    n = 1 << 20
    p = costs.msm_limb_products({"g1": [n, n, n - 1, n], "g2": [n]})
    assert 3.8e11 < p < 3.9e11
