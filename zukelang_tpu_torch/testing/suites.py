"""The reference's integration-test program suite.

The 13 combinator-DSL programs from `Test.Make_suites`
(src/lib/test/test.ml:195-276), exercising every language construct:
cubic demo, if, the no-$ONE edge case, pairs, bool/compound eq,
either/case, input-without-let, compound in/out, uint32 add/sub.

Each entry is a thunk (programs allocate fresh Vars when built).  The
port's own copy of `zukelang_tpu/testing/suites.py`.
"""

from __future__ import annotations

from ..core import lang as L


def _cubic():
    # I know x such that x^3 + x + 3 = y   (test.ml:195-197; README.md:49)
    return L.let_(L.input("input", L.SECRET, L.ty_field),
                  lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))


def _if():
    # test.ml:200-202
    return L.let_(L.input("input", L.SECRET, L.ty_field),
                  lambda x: L.if_(L.eq(x, L.fnum(0)), L.fnum(1), L.fnum(2)))


def _no_one():
    # x*x — no $ONE occurs in the circuit (test.ml:204-213)
    return L.let_(L.input("input", L.SECRET, L.ty_field),
                  lambda x: L.mul(x, x))


def _simple_pair():
    # test.ml:215-217
    return L.let_(L.input("input", L.SECRET, L.ty_field),
                  lambda x: L.pair(L.add(x, L.fnum(1)), L.mul(x, x)))


def _complex_pair():
    # $ONE in the code but gone from the circuit (test.ml:219-227)
    return L.let_(
        L.input("input", L.SECRET, L.ty_field),
        lambda x: L.let_(
            L.pair(L.pair(L.add(x, L.fnum(1)), L.mul(x, x)), L.mul(L.mul(x, x), x)),
            lambda y: L.snd(L.fst(y))))


def _bool_compound_eq():
    # (x,y) == (y,x) for bools (test.ml:229-234)
    return L.let_(
        L.input("input", L.SECRET, L.ty_bool),
        lambda x: L.let_(
            L.input("input2", L.SECRET, L.ty_bool),
            lambda y: L.eq(L.pair(x, y), L.pair(y, x))))


def _either():
    # test.ml:236-240
    return L.let_(
        L.input("input", L.SECRET, L.ty_bool),
        lambda x: L.if_(x, L.left(x, L.ty_bool), L.right(L.ty_bool, x)))


def _case():
    # test.ml:242-246
    return L.let_(
        L.input("input", L.SECRET, L.ty_either(L.ty_field, L.ty_bool)),
        lambda x: L.case(x, lambda i: L.eq(i, L.fnum(0)), lambda b: b))


def _secret_without_let():
    # test.ml:248-251
    return L.add(L.input("input", L.SECRET, L.ty_field), L.fnum(1))


def _compound_output():
    # test.ml:253-257
    return L.let_(L.input("input", L.SECRET, L.ty_field),
                  lambda x: L.pair(L.add(x, L.fnum(1)), L.add(x, L.fnum(2))))


def _compound_input():
    # test.ml:259-263
    return L.let_(L.input("input", L.SECRET, L.ty_pair(L.ty_field, L.ty_field)),
                  lambda x: L.add(L.fst(x), L.snd(x)))


def _uint32_add():
    # test.ml:265-269
    return L.let_(L.input("input", L.SECRET, L.ty_uint32),
                  lambda x: L.add_u32(x, x))


def _uint32_sub():
    # test.ml:271-276
    return L.let_(
        L.input("input", L.SECRET, L.ty_uint32),
        lambda x: L.let_(L.input("input2", L.SECRET, L.ty_uint32),
                         lambda y: L.sub_u32(x, y)))


SUITE = [
    ("cubic", _cubic),
    ("if", _if),
    ("no_one", _no_one),
    ("simple_pair", _simple_pair),
    ("complex_pair", _complex_pair),
    ("bool_compound_eq", _bool_compound_eq),
    ("either", _either),
    ("case", _case),
    ("secret_without_let", _secret_without_let),
    ("compound_output", _compound_output),
    ("compound_input", _compound_input),
    ("uint32_add", _uint32_add),
    ("uint32_sub", _uint32_sub),
]
