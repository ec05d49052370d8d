"""The traffic generator: one seed, one instance; every witness satisfies
its circuit and is full width."""

import numpy as np
import pytest

from zkbench import generator

CONF = {"gates": 256, "domain_log": 8}
RAND = {"witnesses": 4}
BIG_SEED = 2 ** 31 + 987654321


def test_same_seed_same_instance():
    a = generator.build(CONF, RAND, BIG_SEED)
    b = generator.build(CONF, RAND, BIG_SEED)
    c = generator.build(CONF, RAND, BIG_SEED + 1)
    for x, y in zip(a.gates, b.gates):
        assert np.array_equal(x, y)
    assert a.witnesses == b.witnesses and a.trapdoor == b.trapdoor
    assert a.witnesses != c.witnesses and a.trapdoor != c.trapdoor
    ga, gb = a.proof_scalars(), b.proof_scalars()
    assert [next(ga) for _ in range(5)] == [next(gb) for _ in range(5)]
    assert a.sample() == b.sample()


def test_sample_of_the_first_proves():
    for seed in range(20):
        s = generator.build(CONF, RAND, seed).sample()
        assert len(set(s)) == generator.REDUCTION_SAMPLE
        assert all(0 <= i < generator.SAMPLE_AMONG for i in s)


def test_witnesses_satisfy_and_differ():
    inst = generator.build(CONF, RAND, 7)
    assert len(inst.witnesses) == 4
    assert len({w[1] for w in inst.witnesses}) == 4     # distinct inputs
    for k in range(4):
        assert generator.satisfied(inst, k)
        assert len(inst.witnesses[k]) == inst.n_vars
    assert set(inst.ios.tolist()) | set(inst.mids.tolist()) == set(
        range(inst.n_vars))


def test_rand_chain_is_full_width():
    inst = generator.build(CONF, RAND, 3)
    wide = sum(v.bit_length() > 200 for v in inst.witnesses[0][2:])
    assert wide > 0.9 * (inst.n_vars - 2)


def test_too_many_gates():
    with pytest.raises(ValueError):
        generator.build({"gates": 17, "domain_log": 4}, RAND, 1)
