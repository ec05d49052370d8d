"""A G2 window of the port's per-window MSM program (the K8 route with
the plain versions on the CPU) against the JAX package's
`_jit_window("g2", 4, affine=True)` on CPU, on signed digits.

Tolerance: exact, as compressed golden points."""

import jax.numpy as jnp
import torch

from test_torch_window_combine import _b, _case
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import msm

torch.set_num_threads(1)


def test_g2_window_program_matches_jax_jit_window():
    c = 4
    _pts, _scs, ja, pa, dig = _case("g2", 64, 62, c)
    assert int(dig[40].min()) < 0
    run = msm.window_program("g2", c, affine=True)
    want = CJ.unpack_g2(jmsm._jit_window("g2", c, affine=True)(
        ja, jnp.asarray(dig[40].numpy())))
    assert _b(C.unpack_g2(run(pa, dig[40]))) == _b(want)
