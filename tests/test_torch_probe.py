"""The looped-product probe's plain path: `kernels.mont_mul_looped` on CPU
tensors (its plain version, K1's) against the JAX package's
`field_jax.mont_mul` on CPU (XLA), for Fr and Fq, with 0, 1 and p - 1
among the inputs; the probe's own inputs and comparison at a small size.

Tolerance: exact, limbs equal after the 16 -> 32-bit repack."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu_torch import probe_looped
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.params import FQ, FR

torch.set_num_threads(1)


@pytest.mark.parametrize("spec,jspec", [(FR, FJ.FR), (FQ, FJ.FQ)],
                         ids=["fr", "fq"])
def test_mont_mul_looped_plain_matches_jax_mont_mul(spec, jspec):
    r = random.Random(spec.nl)
    edge = [0, 1, spec.p - 1]
    av = edge + edge[::-1] + [r.randrange(spec.p) for _ in range(250)]
    bv = edge[::-1] + edge + [r.randrange(spec.p) for _ in range(250)]
    a, b = F.pack_mont(av, spec), F.pack_mont(bv, spec)
    got = K.mont_mul_looped(a, b, spec)
    want = FJ.mont_mul(jnp.asarray(FJ.pack_mont(av, jspec)),
                       jnp.asarray(FJ.pack_mont(bv, jspec)), jspec)
    assert np.array_equal(F.to_jax(got), np.asarray(want))
    assert F.unpack_mont(got, spec) == [x * y % spec.p for x, y in zip(av, bv)]
    assert K.LAUNCHES["mont_mul_looped"] == 0


def test_probe_inputs_and_comparison_on_cpu_tensors():
    res, (a, b, out) = probe_looped.run(9, torch.device("cpu"),
                                        log=lambda s: None)
    assert res["identical"] and a.shape == b.shape == out.shape == (12, 512)
    assert torch.equal(a[:, :256], a[:, 256:])          # 256 values, tiled
    assert torch.equal(out, K.mont_mul_plain(a, b, FQ))
