"""The port's per-window MSM program over whole MSMs: every window of the
signed digits through `msm.window_program` (plain K4, K8, K7, K2 on the
CPU), combined on the host as sum_w 2^(cw) W_w, equals golden `G1.dot`
and the port's `msm_staged`; the Jacobian variants (chunked and
log-depth) against the JAX package's `_jit_window` on CPU.  The G2
window is in test_torch_window_g2.py.

Tolerance: exact, as compressed golden points."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.golden.curve import G1, G2
from zukelang_tpu.golden.field import Fr
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.ops import msm as jmsm
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FR

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)


def _b(points):
    return [p.to_compressed_bytes() for p in points]


def _case(group, n, seed, c):
    """Golden bases (one infinity), scalars, signed digits, and the
    affine batches of both packages."""
    r = random.Random(seed)
    gen = (G1 if group == "g1" else G2).generator()
    pts = [gen * r.randrange(1, 1 << 64) for _ in range(n - 1)]
    pts.append((G1 if group == "g1" else G2).zero())
    scs = [r.randrange(params.R) for _ in range(n)]
    if group == "g1":
        ja = CJ.to_affine(CJ.pack_g1(pts), CJ.FQ_OPS)
    else:
        ja = CJ.to_affine(CJ.pack_g2(pts), CJ.FQ2_OPS)
    pa = C.from_jax(tuple(np.asarray(x) for x in ja))
    dig = msm._scalars_to_signed_windows(F.pack(scs, FR), c)
    return pts, scs, ja, pa, dig


def test_windows_combined_equal_golden_dot_and_msm_staged():
    n, c = 64, 4
    pts, scs, _ja, pa, dig = _case("g1", n, 61, c)
    run = msm.window_program("g1", c, affine=True)
    acc = None
    for w in reversed(range(dig.shape[0])):
        ww = C.unpack_g1(run(pa, dig[w]))[0]
        acc = ww if acc is None else acc * (1 << c) + ww
    want = G1.dot(pts, [Fr(s) for s in scs])
    assert _b([acc]) == _b([want])
    assert _b([msm.msm_staged(pa, F.pack(scs, FR), "g1", c)]) == _b([want])


@pytest.mark.parametrize("chunked,signed", [(True, True), (False, True),
                                            (False, False)],
                         ids=["chunked", "log_depth", "log_depth_unsigned"])
def test_jacobian_window_program_matches_jax(chunked, signed):
    """Jacobian bases: the chunked route (a K2 loop in phase 1) and the
    log-depth one (`_bucket_sums`), each against its JAX route; unsigned
    digits take 2^c buckets."""
    c = 4
    _pts, scs, ja, pa, dig = _case("g1", 64, 63, c)
    if not signed:
        dig = msm._scalars_to_windows(F.pack(scs, FR), c)
    jj = CJ.affine_to_jac(ja, CJ.FQ_OPS)
    run = msm.window_program("g1", c, chunked=chunked, signed=signed)
    jrun = jmsm._jit_window("g1", c, chunked=chunked, signed=signed)
    want = CJ.unpack_g1(jrun(jj, jnp.asarray(dig[5].numpy())))
    assert _b(C.unpack_g1(run(C.affine_to_jac(pa), dig[5]))) == _b(want)
