"""The port's DSL, compiler, QAP and front end against the JAX package's:
the reference suite's 13 programs and the front end's programs compile to
the same gates, ios and mids; QAPs on both domains have the same
coefficients; the same `Gen` gives the same inputs and `code_eval_list`
the same witness.

The two packages keep separate Var counters, each with ONE = serial 1:
every program is built in both after both counters are reset to the same
value (`same_counters`).  Values compare across packages by their ints
and Vars by (name, id) (`plain`).  Tolerance: exact."""

import contextlib

import pytest

from zukelang_tpu.core import comp as jcomp, qap as jqap, var as jvar
from zukelang_tpu.frontend import compile_python as jcompile_python
from zukelang_tpu.rng import Gen as JGen
from zukelang_tpu.testing.suites import SUITE as JSUITE
from zukelang_tpu_torch.core import circuit, comp, flat, poly, qap as qap_mod
from zukelang_tpu_torch.core import var
from zukelang_tpu_torch.engine import torch_engine
from zukelang_tpu_torch.frontend import compile_python
from zukelang_tpu_torch.rng import Gen
from zukelang_tpu_torch.testing.suites import SUITE

from test_frontend import PROGRAMS, src

SUITE_NAMES = [name for name, _ in SUITE]


@contextlib.contextmanager
def same_counters(n: int = 1):
    """Both packages' Var counters at n inside the block, restored after."""
    saved = jvar.counter_value(), var.counter_value()
    jvar.reset(n)
    var.reset(n)
    try:
        yield
    finally:
        jvar.reset(saved[0])
        var.reset(saved[1])


@pytest.fixture(scope="module")
def small_windows():
    """The engine's windows pinned small (MSM c = 4, fixed base c = 4), as
    the other CPU tests pin them, for a module's tests; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "DEFAULT_MSM_WINDOW", 4)
        mp.setattr(torch_engine, "DEFAULT_FB_WINDOW", 4)
        yield


def plain(x):
    """A value of either package in a form that compares across them:
    Vars as (name, id), field elements as ints, affines and gates by key,
    containers element by element (sets sorted)."""
    kind = type(x).__name__
    if kind == "Var":
        return (x.name, x.id)
    if kind == "Fr":
        return x.n
    if kind in ("Affine", "Gate"):
        return x.key()
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def both_programs(name: str):
    """(JAX expression, port expression) of a suite program, each built
    from the same counter value."""
    with same_counters():
        je = dict(JSUITE)[name]()
    with same_counters():
        te = dict(SUITE)[name]()
    return je, te


def compile_both(je, te):
    """Compile in each package from the same counter value (the compiler
    allocates Vars too)."""
    with same_counters(100):
        jc = jcomp.compile_expr(je)
    with same_counters(100):
        tc = comp.compile_expr(te)
    return jc, tc


def _circuit_view(c):
    return dict(gates=plain(c.gates), ios=plain(c.circuit.ios()),
                mids=plain(c.circuit.mids),
                inputs_public=plain(c.circuit.inputs_public),
                outputs=plain(c.circuit.outputs), codes=repr(c.codes),
                result=plain(c.result))


def _qap_view(q):
    return dict(v=plain(q.v), w=plain(q.w), y=plain(q.y),
                target=plain(q.target), logn=q.logn, gates=plain(q.gates))


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_suite_program_compiles_and_evaluates_as_jax(name):
    jc, tc = compile_both(*both_programs(name))
    assert _circuit_view(tc) == _circuit_view(jc)
    for domain in ("reference", "ntt"):
        assert (_qap_view(qap_mod.build(tc.gates, domain))
                == _qap_view(jqap.build(jc.gates, domain)))
    for seed in (0, 1):
        _i, jl, jenv = jcomp.gen_inputs(jc.inputs, JGen(seed))
        _i, tl, tenv = comp.gen_inputs(tc.inputs, Gen(seed))
        assert repr(tl) == repr(jl) and plain(tenv) == plain(jenv)
        try:
            jsol = jcomp.code_eval_list(jenv, jc.codes)
        except ZeroDivisionError:
            with pytest.raises(ZeroDivisionError):
                comp.code_eval_list(tenv, tc.codes)
            continue
        assert plain(comp.code_eval_list(tenv, tc.codes)) == plain(jsol)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_frontend_program_compiles_as_jax(name):
    with same_counters():
        je = jcompile_python(src(PROGRAMS[name]))
    with same_counters():
        te = compile_python(src(PROGRAMS[name]))
    assert repr(te) == repr(je)
    jc, tc = compile_both(je, te)
    assert _circuit_view(tc) == _circuit_view(jc)
    ti, _l, tenv = comp.gen_inputs(tc.inputs, Gen(5))
    _i, _l, jenv = jcomp.gen_inputs(jc.inputs, JGen(5))
    _c, tenv2 = comp.convert_inputs(
        tc.inputs, {k: v for k, (_s, v, _b) in ti.items()})
    assert plain(tenv2) == plain(tenv) == plain(jenv)


def test_qap_decompile_and_eval_witness():
    """`decompile` gives the gates back on both domains, and
    `eval_witness` gives p = h * target, as in the JAX package."""
    jc, tc = compile_both(*both_programs("case"))
    _i, _l, env = comp.gen_inputs(tc.inputs, Gen(2))
    sol = comp.code_eval_list(env, tc.codes)
    _i, _l, jenv = jcomp.gen_inputs(jc.inputs, JGen(2))
    jsol = jcomp.code_eval_list(jenv, jc.codes)
    for domain in ("reference", "ntt"):
        q = qap_mod.build(tc.gates, domain)
        assert plain(circuit.sort_gates(qap_mod.decompile(q))) == plain(
            circuit.sort_gates(tc.gates))
        p, h = qap_mod.eval_witness(sol, q)
        assert poly.equal(p, poly.mul(h, q.target))
        jp, jh = jqap.eval_witness(jsol, jqap.build(jc.gates, domain))
        assert plain(p) == plain(jp) and plain(h) == plain(jh)


def test_one_is_the_first_var_and_flatten_takes_both_packages_gates():
    from zukelang_tpu.core.circuit import ONE as JONE
    assert (circuit.ONE.name, circuit.ONE.id) == ("ONE", 1) == (JONE.name,
                                                              JONE.id)
    jc, tc = compile_both(*both_programs("bool_compound_eq"))
    a, b = flat.flatten(tc.gates), flat.flatten(jc.gates)
    assert plain(a.vars_sorted) == plain(b.vars_sorted)
    for side in ("l", "r", "lhs"):
        for f in ("idx", "coef", "t_var", "t_gate", "t_coef"):
            assert (getattr(getattr(a, side), f)
                    == getattr(getattr(b, side), f)).all()
    assert [g.key() for g in circuit.sort_gates(tc.gates + tc.gates)] == [
        g.key() for g in tc.circuit.gates]
