"""The port's MSM micro-benchmark (`zukelang_tpu_torch/bench_msm.py`) and
`msm_staged` on Jacobian bases, on the CPU (the kernels' plain versions),
against the golden oracle (compiling the JAX package's fused MSM program
on the CPU costs minutes).

`bench_msm.main` at 2^6 terms, c = 4, prints the JAX script's lines, each
MSM line ending in OK (held against golden `G1.dot`), and its Jacobian
and affine results are equal: the G1 case of the Jacobian route, which
used to fail with "too many values to unpack".  The fixed-base window of
its point generation is pinned to 4, as the other CPU tests pin theirs.
The G2 case: Jacobian bases with Z != 1 equal the affine route and
golden `G2.dot`, and `resolve()` re-dispatches nothing on that route.

Tolerance: exact (golden points)."""

import functools
import random
import re

import torch

from zukelang_tpu_torch import bench_msm, params
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fq2, Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.params import FQ, FR

torch.set_num_threads(1)


def test_bench_msm_main_prints_the_jax_lines(capsys, monkeypatch):
    monkeypatch.setattr(msm, "fixed_base_mul",
                        functools.partial(msm.fixed_base_mul, c=4))
    out = bench_msm.main(["6", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"point gen: \d+\.\d\ds", lines[0])
    assert re.fullmatch(r"to_affine: \d+\.\d\ds", lines[1])
    for line, tag in zip(lines[2:], ("jac", "aff")):
        assert re.fullmatch(
            rf"G1 MSM\[{tag}\] 2\^6 c=4: \d+\.\d{{3}}s warm "
            r"\(\d+\.\d\d Mterm/s\), first \d+\.\ds OK", line), line
    assert len(lines) == 4
    res = out["results"]
    assert set(res) == {("jac", 4), ("aff", 4)}
    assert res[("jac", 4)] == res[("aff", 4)]
    g = G1.generator()
    assert res[("jac", 4)] == G1.dot([g * k for k in out["ks"]],
                                     [Fr(s) for s in out["scalars"]])
    assert len(out["points"]) == 3 and len(out["affine"]) == 2


def _jacobian_g2(points, r):
    """Golden G2 points -> a Jacobian batch with random Z != 1: (x z^2,
    y z^3, z); infinity as (0, 1, 0)."""
    cols = [[] for _ in range(6)]
    for pt in points:
        if pt.is_zero():
            vals = (0, 0, 1, 0, 0, 0)
        else:
            z = Fq2.of_ints(r.randrange(1, params.P), r.randrange(params.P))
            z2 = z * z
            x, y = pt.x * z2, pt.y * z2 * z
            vals = (x.c0.n, x.c1.n, y.c0.n, y.c1.n, z.c0.n, z.c1.n)
        for c, v in zip(cols, vals):
            c.append(v)
    packed = [F.pack_mont(c, FQ) for c in cols]
    return tuple(torch.stack(packed[2 * i:2 * i + 2]) for i in range(3))


def test_jacobian_bases_g2_equal_affine_and_golden(monkeypatch):
    r = random.Random(4)
    g = G2.generator()
    pts = [g * r.randrange(1, 1 << 30) for _ in range(63)] + [G2.zero()]
    scalars = [r.randrange(params.R) for _ in range(64)]
    S = F.pack(scalars, FR)
    want = G2.dot(pts, [Fr(s) for s in scalars])
    assert msm.msm_staged(C.pack_affine(pts, "g2"), S, "g2", 4) == want

    def no_redispatch(*_a, **_k):
        raise AssertionError("the Jacobian route re-dispatched")

    monkeypatch.setattr(msm, "_msm_safe_impl", no_redispatch)
    jac = _jacobian_g2(pts, r)
    assert not all(bool(F.eq(z, F.ones_mont(64, FQ)).all()) for z in jac[2])
    resolve = msm.msm_staged_deferred(jac, S, "g2", 4)
    assert C.unpack_g2(resolve())[0] == want
