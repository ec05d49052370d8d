"""The NTT kernel's plain version (`ops/ntt.py` `transform_plain`) and the
fused witness reduction against the JAX package's ops/ntt.py and
engine/jax_engine.py on the same seeded inputs, at every tile split the
CPU can reach; and, marked `gpu`, the kernel (`csrc/ntt.cu`) against its
plain version on the card.

The JAX package is imported inside the `jref` fixture, so the `gpu` cases
also run where JAX is absent (the card's machine):

    python -m pytest --noconftest -m gpu tests/test_torch_ntt_kernel.py -q

Tolerance: none.  Every result is a canonical field element, so any
order of the butterflies gives the reference's words: a difference is a
bug."""

import random
import types

import numpy as np
import pytest
import torch

from zukelang_tpu_torch import bench_lib, params
from zukelang_tpu_torch.engine import torch_engine as te
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import ntt

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

FORMS = ("ntt", "intt", "coset_ntt", "coset_intt")
LOG_TILES = (1, 2, 3, 4, 5, None)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's NTT, engine and flat modules, and jax itself."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from zukelang_tpu.core import flat as jflat
    from zukelang_tpu.engine import jax_engine as je
    from zukelang_tpu.ops import field_jax as FJ
    from zukelang_tpu.ops import ntt as jntt
    return types.SimpleNamespace(jax=jax, jnp=jnp, jflat=jflat, je=je,
                                 FJ=FJ, jntt=jntt)


def _batch(logn, seed, B=3, dev=None):
    """(B, nl, N) random Montgomery vectors (a zero and p - 1 among them)."""
    rng = random.Random(seed)
    vals = [rng.randrange(params.R) for _ in range(B << logn)]
    vals[0], vals[-1] = 0, params.R - 1
    x = F.pack_mont(vals, F.FR, dev)
    return x.reshape(F.FR.nl, B, 1 << logn).transpose(0, 1).contiguous()


def _same(t, arr):
    assert np.array_equal(F.to_jax(t), np.asarray(arr))


def test_pass_plan():
    assert ntt.passes(16, ntt.LOG_TILE) == ((0, 11), (11, 5))
    assert ntt.passes(20, ntt.LOG_TILE) == ((0, 11), (11, 9))
    assert ntt.passes(11, ntt.LOG_TILE) == ((0, 11),)
    assert ntt.passes(1, ntt.LOG_TILE) == ((0, 1),)
    assert ntt.passes(0, ntt.LOG_TILE) == ((0, 0),)
    assert ntt.passes(12, 5) == ((0, 5), (5, 5), (10, 2))
    assert ntt.passes(12) == ((0, 12),)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("logn", range(1, 13))
def test_plain_forms_match_jax_at_every_split(jref, logn, form):
    """The four forms, batched B = 3, one pass and every split into
    tiles of 2^1 .. 2^5 points, word-equal to the JAX package's forms
    (vmapped over the batch, under jit)."""
    x = _batch(logn, 100 * logn + FORMS.index(form))
    xj = jref.jnp.asarray(F.to_jax(x))                 # (B, 16, N)
    want = jref.jax.jit(jref.jax.vmap(getattr(jref.jntt, form)))(xj)
    for log_tile in LOG_TILES:
        got = getattr(ntt, form + "_plain")(x, log_tile=log_tile)
        _same(got, want)
    _same(getattr(ntt, form)(x), want)                 # the CPU wrapper
    _same(getattr(ntt, form)(x[1]), want[1])           # one (nl, N) vector


def test_plain_forms_at_one_point_and_round_trip():
    x = _batch(0, 5)
    for form in FORMS[:2]:
        assert torch.equal(getattr(ntt, form + "_plain")(x), x)
    y = _batch(9, 6)
    for log_tile in (2, 4, None):
        assert torch.equal(ntt.intt_plain(ntt.ntt_plain(y, log_tile=log_tile),
                                          log_tile=log_tile), y)
        assert torch.equal(ntt.coset_intt_plain(
            ntt.coset_ntt_plain(y, log_tile=log_tile), log_tile=log_tile), y)


def _cubic():
    """The compiled x^3 + x + 3 circuit (its lhs rows have K > 1 terms and
    it has fewer gates than its domain) and its witness, both packages."""
    from zukelang_tpu.core import comp, lang as L
    from zukelang_tpu.rng import Gen
    from zukelang_tpu_torch.core import flat as tflat
    from zukelang_tpu.core import flat as jflat
    e = L.let_(L.input("input", L.SECRET, L.ty_field),
               lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))
    c = comp.compile_expr(e)
    _i, _env_lang, env_code = comp.gen_inputs(c.inputs, Gen(3))
    sol = comp.code_eval_list(env_code, c.codes)
    fj, ft = jflat.flatten(c.gates), tflat.flatten(c.gates)
    return fj, fj.pack_witness(sol), ft, ft.pack_witness(sol)


def _synthetic(log_constraints, seed):
    from zukelang_tpu import bench_lib as jbench
    ij = jbench.make_synthetic_r1cs(log_constraints, seed=seed)
    it = bench_lib.make_synthetic_r1cs(log_constraints, seed=seed)
    return ij.fc, ij.pack_witness(), it.fc, it.pack_witness()


@pytest.mark.parametrize("circuit", ["cubic", "synthetic_2^8"])
def test_fused_reduction_plain_matches_jax(jref, circuit):
    """The fused reduction's plain version (one pass, and the kernel's
    split into tiles of 2^2 and 2^3 points) and the CPU wrapper,
    word-equal to `jax_engine.run_witness_reduction`."""
    fj, wj, ft, wt = _cubic() if circuit == "cubic" else _synthetic(8, 3)
    if circuit == "cubic":
        assert max(s.widest for s in ft.sides) > 1
        assert ft.n_gates < 1 << ft.logn
    want = jref.je.run_witness_reduction(fj, jref.jnp.asarray(wj))
    args = (*(te.side_tensors(s, "cpu") for s in ft.sides), wt)
    for log_tile in (None, 2, 3):
        got = te.witness_reduction_plain(ft.logn, log_tile)(*args)
        for g, w in zip(got, want):
            _same(g, w)
    for g, w in zip(te.run_witness_reduction(ft, wt), want):
        _same(g, w)


def test_side_tensors_are_made_once_per_device():
    _fj, _wj, ft, _wt = _synthetic(4, 1)
    first = te.side_tensors(ft.l, torch.device("cpu"))
    assert te.side_tensors(ft.l, "cpu") is first
    assert (first[0].dtype, first[1].dtype) == (torch.int32, torch.int32)
    assert np.array_equal(first[0].numpy(), ft.l.offsets)
    assert np.array_equal(first[1].numpy(), ft.l.cols)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("logn", [0, 1, 2, 5, 10, 11, 12, 13, 16])
def test_ntt_kernel_equals_plain(dev, logn):
    """Every form on the card, B = 3, against the plain version on the
    same inputs; one launch a pass (two from 2^12)."""
    x = _batch(logn, 7 + logn, dev=dev)
    for form in FORMS:
        before = K.LAUNCHES["ntt"]
        got = getattr(ntt, form)(x)
        passes = len(ntt.passes(logn, ntt.LOG_TILE))
        assert K.LAUNCHES["ntt"] - before == passes
        assert torch.equal(got, getattr(ntt, form + "_plain")(x))


@pytest.mark.gpu
def test_fused_reduction_kernel_equals_plain(dev):
    """The witness reduction in six launches at 2^12, word-equal to its
    plain version."""
    inst = bench_lib.make_synthetic_r1cs(12, seed=3)
    wm = inst.pack_witness(dev)
    before = dict(K.LAUNCHES)
    got = te.run_witness_reduction(inst.fc, wm)
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS}
    assert launched == {k: 6 if k == "ntt" else 0 for k in K.KERNELS}
    args = (*(te.side_tensors(s, dev) for s in inst.fc.sides), wm)
    want = te.witness_reduction_plain(12)(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_fused_reduction_ragged_kernel_equals_plain(dev):
    """Ragged rows of 0 to 255 terms (mostly 1-3, as in the Sapling
    Spend circuit) at 2^12, six launches, word-equal to the plain
    version; the sides on the card take nnz x 36 B + (G + 1) x 4 B."""
    from zukelang_tpu_torch.core import flat
    rng = random.Random(8)
    G, V, R = 3000, 5000, params.R
    widths = (1,) * 20 + (3,) * 10 + (2, 0, 34, 96, 255)
    sides = []
    for s in range(3):
        off, cols, coefs = [0], [], []
        for g in range(G):
            k = widths[(7 * g + s) % len(widths)]
            cols += rng.sample(range(V), k)
            coefs += [rng.choice((1, R - 1, rng.randrange(R)))
                      for _ in range(k)]
            off.append(len(cols))
        sides.append((off, cols, coefs))
    fc = flat.from_arrays(V, 12, *sides)
    wm = flat.pack_witness_values([1] + [rng.randrange(R)
                                         for _ in range(V - 1)], dev)
    before = dict(K.LAUNCHES)
    got = te.run_witness_reduction(fc, wm)
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS}
    assert launched == {k: 6 if k == "ntt" else 0 for k in K.KERNELS}
    args = [te.side_tensors(s, dev) for s in fc.sides]
    for s, t in zip(fc.sides, args):
        assert sum(x.numel() * x.element_size() for x in t) == (
            s.nnz * 36 + (G + 1) * 4)
    want = te.witness_reduction_plain(12)(*args, wm)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
