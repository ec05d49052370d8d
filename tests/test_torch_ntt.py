"""The port's NTT and witness-reduction pipeline against the JAX
package's ops/ntt.py and engine/jax_engine.py, on the same seeded inputs.

Tolerance: integer limbs, exact equality after repacking."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu import params
from zukelang_tpu.core import comp, flat as jflat, lang as L
from zukelang_tpu.engine import jax_engine as je
from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu.ops import ntt as jntt
from zukelang_tpu.rng import Gen
from zukelang_tpu_torch.core import flat as tflat
from zukelang_tpu_torch.engine import torch_engine as te
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import ntt

from jax_flat import assert_side_matches_jax

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)


def _same(t, arr):
    assert np.array_equal(F.to_jax(t), np.asarray(arr))


@pytest.mark.parametrize("logn", [3, 4, 5, 6])
def test_ntt_forms_match_jax(logn):
    rng = random.Random(logn)
    xs = [rng.randrange(params.R) for _ in range(1 << logn)]
    xj = FJ.pack_mont(xs, FJ.FR)
    xt = F.from_jax(np.asarray(xj))
    for fj, ft in ((jntt.ntt, ntt.ntt), (jntt.intt, ntt.intt),
                   (jntt.coset_ntt, ntt.coset_ntt),
                   (jntt.coset_intt, ntt.coset_intt)):
        _same(ft(xt), jax.jit(fj)(xj))
    assert ntt.zh_on_coset_inv(logn) == jntt.zh_on_coset_inv(logn)
    assert F.unpack_mont(ntt.intt(ntt.ntt(xt)), F.FR) == xs


def _circuit():
    e = L.let_(L.input("input", L.SECRET, L.ty_field),
               lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))
    c = comp.compile_expr(e)
    _i, _env_lang, env_code = comp.gen_inputs(c.inputs, Gen(3))
    return c, comp.code_eval_list(env_code, c.codes)


def test_flatten_matches_jax_flat():
    c, sol = _circuit()
    fj, ft = jflat.flatten(c.gates), tflat.flatten(c.gates)
    assert fj.logn == ft.logn and fj.vars_sorted == ft.vars_sorted
    for name in ("l", "r", "lhs"):
        assert_side_matches_jax(getattr(fj, name), getattr(ft, name),
                                len(fj.vars_sorted))
    _same(ft.pack_witness(sol), fj.pack_witness(sol))


def test_run_witness_reduction_bit_equal_to_jax():
    c, sol = _circuit()
    fj, ft = jflat.flatten(c.gates), tflat.flatten(c.gates)
    want = je.run_witness_reduction(fj, jnp.asarray(fj.pack_witness(sol)))
    got = te.run_witness_reduction(ft, ft.pack_witness(sol))
    for g, w in zip(got, want):
        _same(g, w)


def test_keygen_evaluation_at_tau_matches_jax():
    c, _sol = _circuit()
    fj, ft = jflat.flatten(c.gates), tflat.flatten(c.gates)
    x = 0x1234567890ABCDEF
    lj, lt = je._lagrange_at(fj.logn, x), te._lagrange_at(ft.logn, x)
    _same(lt, lj)
    nv = len(fj.vars_sorted)
    for name in ("l", "r", "lhs"):
        sj = getattr(fj, name)
        want = je._jit_transpose_matvec(nv)(
            jnp.asarray(sj.t_var), jnp.asarray(sj.t_gate),
            jnp.asarray(sj.t_coef), lj)
        _same(te.transpose_matvec(getattr(ft, name), lt, nv), want)
