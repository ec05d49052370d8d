"""The port's levelized witness evaluator (`zukelang_tpu_torch/core/
witness.py`) against the JAX package's (`zukelang_tpu/core/witness.py`)
and the sequential `comp.code_eval_list`, on the CPU (K1's plain version
carries the device path's products).

Each suite program is built in both packages from the same Var counter
value (`test_torch_core.same_counters`), with inputs from the same seeds;
Vars compare by (name, id), field elements by their ints.  The compiled
programs and the device plans must equal the JAX ones slot for slot, the
envs must be equal, and ZeroDivisionError must be raised in exactly the
cases where the sequential evaluator raises (poison through `div` and
`if`).  The synthetic wide program (`testing/witness_programs.py`) holds
every kind and divisions by zero in untaken branches.

Tolerance: exact."""

import pytest
import torch

from zukelang_tpu.core import comp as jcomp, lang as JL
from zukelang_tpu.core import witness as jwitness
from zukelang_tpu.core.circuit import ONE as JONE
from zukelang_tpu.golden.field import Fr as JFr
from zukelang_tpu.rng import Gen as JGen
from zukelang_tpu.testing.suites import SUITE as JSUITE
from zukelang_tpu_torch.core import comp, lang as L, witness
from zukelang_tpu_torch.core.circuit import ONE
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.rng import Gen
from zukelang_tpu_torch.testing.suites import SUITE
from zukelang_tpu_torch.testing.witness_programs import (FIRST_KINDS,
                                                        wide_program)

from test_torch_core import plain, same_counters

# The plain versions run many small int64 ops: intra-op threads only add
# overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

NAMES = [name for name, _ in SUITE[:8]]


def _inputs(pkg_comp, gen, c, seed):
    _i, _l, env = pkg_comp.gen_inputs(c.inputs, gen(seed))
    gvars = c.circuit.vars()
    return {v: f for v, f in env.items() if v in gvars}


def _both(name, seed):
    """((JAX compiled, env), (port compiled, env)) of a suite program."""
    with same_counters():
        jc = jcomp.compile_expr(dict(JSUITE)[name]())
    with same_counters():
        c = comp.compile_expr(dict(SUITE)[name]())
    return ((jc, _inputs(jcomp, JGen, jc, seed)),
            (c, _inputs(comp, Gen, c, seed)))


def _steps(prog):
    return [[(st.kind, st.out, st.args, st.terms, st.level) for st in lv]
            for lv in prog.levels]


@pytest.mark.parametrize("name", NAMES)
def test_program_and_plan_equal_the_jax_package(name):
    (jc, jenv), (c, env) = _both(name, 5)
    jprog = jwitness.compile_witness_program(jc.codes, list(jenv))
    prog = witness.compile_witness_program(c.codes, list(env))
    assert (prog.n_slots, prog.n_steps) == (jprog.n_slots, jprog.n_steps)
    assert [len(lv) for lv in prog.levels] == [len(lv) for lv in jprog.levels]
    assert _steps(prog) == _steps(jprog)
    assert plain(prog.input_slots) == plain(jprog.input_slots)
    assert plain(prog.var_slot) == plain(jprog.var_slot)
    assert plain(prog.code_vars) == plain(jprog.code_vars)
    plan, jplan = witness._plan(prog), jwitness._plan(jprog)
    assert [[op.kind for op in ops] for ops in plan] == [
        [op.kind for op in ops] for ops in jplan]
    for ops, jops in zip(plan, jplan):
        for op, jop in zip(ops, jops):
            assert op.outs.tolist() == jop.outs.tolist()
            assert op.srcs.tolist() == jop.srcs.tolist()
            if jop.coefs is None:
                assert op.coefs is None
            else:
                assert torch.equal(op.coefs, F.from_jax(jop.coefs, axis=0))


@pytest.mark.parametrize("name", NAMES)
def test_eval_equals_sequential_and_the_jax_package(name):
    for seed in (5, 9):
        (jc, jenv), (c, env) = _both(name, seed)
        assert plain(env) == plain(jenv)
        jprog = jwitness.compile_witness_program(jc.codes, list(jenv))
        prog = witness.compile_witness_program(c.codes, list(env))
        try:
            want = comp.code_eval_list(env, c.codes)
        except ZeroDivisionError:
            for ev in (witness.eval_host, lambda p, e: witness.eval_device(
                    p, e, "cpu")):
                with pytest.raises(ZeroDivisionError):
                    ev(prog, env)
            continue
        assert witness.eval_host(prog, env) == want
        assert witness.eval_device(prog, env, "cpu") == want
        jwant = jcomp.code_eval_list(jenv, jc.codes)
        assert plain(want) == plain(jwant)
        assert jwitness.eval_host(jprog, jenv) == jwant
        assert jwitness.eval_device(jprog, jenv) == jwant


def _division_by_zero(lang, comp_mod, one, fr):
    x = lang.input("x", lang.SECRET, lang.ty_field)
    c = comp_mod.compile_expr(lang.let_(x, lambda v: lang.div(lang.fnum(1),
                                                              v)))
    env = {vs[0]: fr(0) for name, (_s, _t, vs) in c.inputs.items()
           if name != "$ONE"}
    env[one] = fr(1)
    return c, env


def test_division_by_zero_poisons():
    """1/x with x = 0: the sequential evaluator raises, so every
    leveled one must, in both packages."""
    for lang, comp_mod, wit, one, fr, dev in (
            (L, comp, witness, ONE, Fr, ("cpu",)),
            (JL, jcomp, jwitness, JONE, JFr, ())):
        c, env = _division_by_zero(lang, comp_mod, one, fr)
        with pytest.raises(ZeroDivisionError):
            comp_mod.code_eval_list(env, c.codes)
        prog = wit.compile_witness_program(c.codes, list(env.keys()))
        with pytest.raises(ZeroDivisionError):
            wit.eval_host(prog, env)
        with pytest.raises(ZeroDivisionError):
            wit.eval_device(prog, env, *dev)


def _untaken_division(lang, comp_mod, one, fr):
    a = lang.input("a", lang.SECRET, lang.ty_bool)
    b = lang.input("b", lang.SECRET, lang.ty_bool)
    c = comp_mod.compile_expr(lang.let_(a, lambda av: lang.let_(
        b, lambda bv: lang.or_(av, bv))))
    env = {vs[0]: fr(0) for name, (_s, _t, vs) in c.inputs.items()
           if name != "$ONE"}
    env[one] = fr(1)
    return c, env


def test_untaken_division_not_poisoned():
    """or(a, b) with a = b = false divides by a + b = 0 in the untaken
    branch of an if (the Or gadget): no evaluator may raise."""
    outs = []
    for lang, comp_mod, wit, one, fr, dev in (
            (L, comp, witness, ONE, Fr, ("cpu",)),
            (JL, jcomp, jwitness, JONE, JFr, ())):
        with same_counters():
            c, env = _untaken_division(lang, comp_mod, one, fr)
        want = comp_mod.code_eval_list(env, c.codes)
        prog = wit.compile_witness_program(c.codes, list(env.keys()))
        assert wit.eval_host(prog, env) == want
        assert wit.eval_device(prog, env, *dev) == want
        outs.append(plain(want))
    assert outs[0] == outs[1]


def test_eval_auto_takes_the_host_for_deep_chains():
    """A multiplicative chain 40 deep is as deep as it has steps:
    `eval_auto` takes the host path (with no device named it would raise
    on the CPU otherwise) and agrees, as the JAX package's does."""
    outs = []
    for lang, comp_mod, wit, gen in ((L, comp, witness, Gen),
                                     (JL, jcomp, jwitness, JGen)):
        def build(v, d):
            if d == 0:
                return v
            return lang.let_(lang.mul(v, v), lambda w: build(w, d - 1))

        with same_counters():
            x = lang.input("x", lang.SECRET, lang.ty_field)
            c = comp_mod.compile_expr(lang.let_(x, lambda v: build(v, 40)))
        env = _inputs(comp_mod, gen, c, 5)
        want = comp_mod.code_eval_list(env, c.codes)
        prog = wit.compile_witness_program(c.codes, list(env))
        assert len(prog.levels) >= 40
        assert wit.eval_auto(prog, env) == want
        outs.append(plain(want))
    assert outs[0] == outs[1]


def test_wide_program_every_kind_and_untaken_zero_divisions():
    """256 lanes x 8 levels, one kind a level: equal to the sequential
    evaluator on both paths, with a quarter of the lanes dividing by zero
    in an untaken branch, each such division's slot poisoned in the
    device path's table and none of the assigned wires."""
    lanes = 256
    codes, env = wide_program(lanes, 8, seed=1)
    prog = witness.compile_witness_program(codes, list(env))
    assert prog.n_steps == lanes * 8
    assert [sorted({st.kind for st in lv}) for lv in prog.levels] == [
        [k] for k in FIRST_KINDS]
    assert all(len(lv) == lanes for lv in prog.levels)
    want = comp.code_eval_list(env, codes)
    dens = [want[v] for v, _c in codes[5 * lanes:6 * lanes]]
    zeros = sum(d.is_zero() for d in dens)
    assert 0 < zeros < lanes
    assert witness.eval_host(prog, env) == want
    assert witness.eval_device(prog, env, "cpu") == want
    vals, pois = witness._device_inputs(prog, env, torch.device("cpu"))
    witness._run_levels(prog, vals, pois)
    div_outs = [st.out for st in prog.levels[6]]
    assert int(pois[div_outs].sum()) == zeros
    assert not bool(pois[[prog.var_slot[v] for v in prog.code_vars]].any())


def test_eval_device_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes, env = wide_program(8, 8, seed=2)
    prog = witness.compile_witness_program(codes, list(env))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        witness.eval_device(prog, env)
