"""The typed ZK DSL: types, expressions, values, and the reference interpreter.

The port's own copy of `zukelang_tpu/core/lang.py`.

Mirrors `Lang.Make(F)` in the reference (src/lib/zk/lang.ml): a small typed
language over field / bool / uint32 / pair / either, with secret/public
inputs, HOAS let/case binders, and a big-step evaluator that defines the
semantics the compiled circuit must agree with.

uint32 values are embedded into Fr as powers of a primitive 2^32-th root of
unity (lang.ml:7-21, curve.ml:241-298): uint32 x  |->  omega^x, so uint32
addition becomes field multiplication and subtraction becomes division.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from .. import params
from ..golden.field import Fr
from . import var as var_mod
from .var import Var


# ---------------------------------------------------------------------------
# Types (lang.ml:28-70)
# ---------------------------------------------------------------------------

class Type:
    """Base of the DSL type language."""

    def components(self) -> int:
        """Width of the flattened field-vector representation
        (comp.ml:125-128): Either adds one tag slot and takes the max arm."""
        raise NotImplementedError


@dataclass(frozen=True)
class TField(Type):
    def components(self):
        return 1

    def __repr__(self):
        return "field"


@dataclass(frozen=True)
class TBool(Type):
    def components(self):
        return 1

    def __repr__(self):
        return "bool"


@dataclass(frozen=True)
class TUint32(Type):
    def components(self):
        return 1

    def __repr__(self):
        return "uint32"


@dataclass(frozen=True)
class TPair(Type):
    t1: Type
    t2: Type

    def components(self):
        return self.t1.components() + self.t2.components()

    def __repr__(self):
        return f"({self.t1!r} * {self.t2!r})"


@dataclass(frozen=True)
class TEither(Type):
    t1: Type
    t2: Type

    def components(self):
        return max(self.t1.components(), self.t2.components()) + 1

    def __repr__(self):
        return f"({self.t1!r}, {self.t2!r}) Either.t"


ty_field = TField()
ty_bool = TBool()
ty_uint32 = TUint32()


def ty_pair(t1: Type, t2: Type) -> Type:
    return TPair(t1, t2)


def ty_either(t1: Type, t2: Type) -> Type:
    return TEither(t1, t2)


PUBLIC = "public"
SECRET = "secret"


# ---------------------------------------------------------------------------
# uint32 <-> Fr embedding (lang.ml:7-21)
# ---------------------------------------------------------------------------

def f_of_uint32(i: int) -> Fr:
    if not 0 <= i <= (1 << 32):
        raise ValueError("uint32 out of range")
    return Fr(pow(params.FR_ROOT_OF_UNITY, i, params.R))


# ---------------------------------------------------------------------------
# Expressions (lang.ml:72-252)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Expr:
    tag: str
    args: Tuple[Any, ...]
    ty: Type

    def __repr__(self):
        return _pp(self)


def _pp(e: Expr) -> str:
    t, a = e.tag, e.args
    if t in ("field", "bool", "uint32"):
        return repr(a[0]) + ("u" if t == "uint32" else "")
    if t == "input":
        return f"(input {a[0]!r} : {a[1]})"
    if t in ("add", "sub", "mul", "div", "and", "or", "eq", "add_u32", "sub_u32"):
        op = {"add": "+", "sub": "-", "mul": "*", "div": "/", "and": "&&",
              "or": "||", "eq": "==", "add_u32": "+u", "sub_u32": "-u"}[t]
        return f"({_pp(a[0])} {op} {_pp(a[1])})"
    if t == "not":
        return f"(not {_pp(a[0])})"
    if t == "neg":
        return f"(- {_pp(a[0])})"
    if t == "if":
        return f"(if {_pp(a[0])} then {_pp(a[1])} else {_pp(a[2])})"
    if t == "to_field":
        return f"(to_field {_pp(a[0])})"
    if t == "check_u32":
        return f"(check_u32 {_pp(a[0])})"
    if t == "let":
        return f"(let {a[0]!r} = {_pp(a[1])} in {_pp(a[2])})"
    if t == "var":
        return repr(a[0])
    if t == "pair":
        return f"({_pp(a[0])}, {_pp(a[1])})"
    if t in ("fst", "snd", "left", "right"):
        return f"({t} {_pp(a[0])})"
    if t == "case":
        return (f"(match {_pp(a[0])} with Left {a[1]!r} -> {_pp(a[2])}"
                f" | Right {a[3]!r} -> {_pp(a[4])})")
    return f"<{t}>"


# -- combinators (lang.ml:157-251) ------------------------------------------

def field(f) -> Expr:
    if isinstance(f, int):
        f = Fr(f)
    return Expr("field", (f,), ty_field)


def fnum(n: int) -> Expr:
    """The reference's `!n` literal."""
    return field(Fr(n))


def boolean(b: bool) -> Expr:
    return Expr("bool", (bool(b),), ty_bool)


def uint32(n: int) -> Expr:
    return Expr("uint32", (n,), ty_uint32)


def add(a, b) -> Expr:
    return Expr("add", (a, b), ty_field)


def sub(a, b) -> Expr:
    return Expr("sub", (a, b), ty_field)


def neg(a) -> Expr:
    return Expr("neg", (a,), ty_field)


def mul(a, b) -> Expr:
    return Expr("mul", (a, b), ty_field)


def div(a, b) -> Expr:
    return Expr("div", (a, b), ty_field)


def not_(a) -> Expr:
    return Expr("not", (a,), ty_bool)


def and_(a, b) -> Expr:
    return Expr("and", (a, b), ty_bool)


def or_(a, b) -> Expr:
    return Expr("or", (a, b), ty_bool)


def if_(c, a, b) -> Expr:
    return Expr("if", (c, a, b), a.ty)


def input(name: str, security: str, ty: Type) -> Expr:
    if security not in (PUBLIC, SECRET):
        raise ValueError("security must be public or secret")
    return Expr("input", (name, security), ty)


def to_field(a: Expr) -> Expr:
    if not isinstance(a.ty, (TField, TBool, TUint32)):
        raise TypeError("to_field on compound type")
    return Expr("to_field", (a,), ty_field)


def var(v: Var, ty: Type) -> Expr:
    return Expr("var", (v,), ty)


def let_(a: Expr, body) -> Expr:
    """HOAS let: body receives a Var expression (lang.ml:210-214)."""
    v = var_mod.make("x")
    b = body(var(v, a.ty))
    return Expr("let", (v, a, b), b.ty)


def eq(a, b) -> Expr:
    return Expr("eq", (a, b), ty_bool)


def pair(a, b) -> Expr:
    return Expr("pair", (a, b), ty_pair(a.ty, b.ty))


def fst(a) -> Expr:
    assert isinstance(a.ty, TPair)
    return Expr("fst", (a,), a.ty.t1)


def snd(a) -> Expr:
    assert isinstance(a.ty, TPair)
    return Expr("snd", (a,), a.ty.t2)


def left(a: Expr, bty: Type) -> Expr:
    return Expr("left", (a,), ty_either(a.ty, bty))


def right(aty: Type, b: Expr) -> Expr:
    return Expr("right", (b,), ty_either(aty, b.ty))


def case(ab: Expr, fa, fb) -> Expr:
    """HOAS match on Either (lang.ml:237-245)."""
    assert isinstance(ab.ty, TEither)
    va = var_mod.make("case")
    vb = var_mod.make("case")
    a = fa(var(va, ab.ty.t1))
    b = fb(var(vb, ab.ty.t2))
    return Expr("case", (ab, va, a, vb, b), a.ty)


def add_u32(a, b) -> Expr:
    return Expr("add_u32", (a, b), ty_uint32)


def check_u32(a: Expr) -> Expr:
    """Range-check gadget: constrains a uint32-typed wire to actually be a
    valid omega^x embedding with x < 2^32 (the reference leaves uint32
    inputs unchecked — the "range check?" comment at lang.ml:179).

    In the interpreter this is the identity; the compiler emits 32 witness
    bits with booleanity gates plus a 31-gate product chain reconstructing
    omega^x (see comp._compile), so no out-of-range or non-torsion value
    can satisfy the circuit."""
    assert isinstance(a.ty, TUint32)
    return Expr("check_u32", (a,), ty_uint32)


def sub_u32(a, b) -> Expr:
    return Expr("sub_u32", (a, b), ty_uint32)


# ---------------------------------------------------------------------------
# Values (lang.ml:254-306)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Value:
    tag: str  # field | bool | uint32 | pair | left | right
    args: Tuple[Any, ...]

    def __repr__(self):
        t, a = self.tag, self.args
        if t == "field":
            return repr(a[0])
        if t == "bool":
            return repr(a[0])
        if t == "uint32":
            return f"{a[0]}u"
        if t == "pair":
            return f"({a[0]!r}, {a[1]!r})"
        return f"{t.capitalize()} {a[0]!r}"


def v_field(f) -> Value:
    return Value("field", (f if isinstance(f, Fr) else Fr(f),))


def v_bool(b: bool) -> Value:
    return Value("bool", (bool(b),))


def v_uint32(n: int) -> Value:
    return Value("uint32", (int(n),))


def v_pair(a: Value, b: Value) -> Value:
    return Value("pair", (a, b))


def v_left(a: Value) -> Value:
    return Value("left", (a,))


def v_right(b: Value) -> Value:
    return Value("right", (b,))


def gen_value(ty: Type, rng) -> Value:
    """Random typed value (lang.ml:271-289); rng is an `rng.Gen`."""
    if isinstance(ty, TField):
        return v_field(rng.field())
    if isinstance(ty, TBool):
        return v_bool(rng.bool())
    if isinstance(ty, TUint32):
        return v_uint32(rng.uint32())
    if isinstance(ty, TPair):
        a = gen_value(ty.t1, rng)
        b = gen_value(ty.t2, rng)
        return v_pair(a, b)
    if isinstance(ty, TEither):
        if rng.bool():
            return v_left(gen_value(ty.t1, rng))
        return v_right(gen_value(ty.t2, rng))
    raise TypeError(ty)


# ---------------------------------------------------------------------------
# Evaluator (lang.ml:319-427) — the semantic oracle for the compiler
# ---------------------------------------------------------------------------

def eval_expr(inputs: dict, e: Expr) -> Value:
    """Big-step evaluation; `inputs` maps input names to Values."""

    def go(env: dict, e: Expr) -> Value:
        t, a = e.tag, e.args
        if t == "input":
            return inputs[a[0]]
        if t == "field":
            return v_field(a[0])
        if t == "bool":
            return v_bool(a[0])
        if t == "uint32":
            return v_uint32(a[0])
        if t in ("add", "sub", "mul", "div"):
            x = go(env, a[0]).args[0]
            y = go(env, a[1]).args[0]
            if t == "add":
                return v_field(x + y)
            if t == "sub":
                return v_field(x - y)
            if t == "mul":
                return v_field(x * y)
            if y.is_zero():
                raise ZeroDivisionError("DSL division by zero")
            return v_field(x / y)
        if t == "neg":
            return v_field(-go(env, a[0]).args[0])
        if t == "not":
            return v_bool(not go(env, a[0]).args[0])
        if t == "and":
            return v_bool(go(env, a[0]).args[0] and go(env, a[1]).args[0])
        if t == "or":
            return v_bool(go(env, a[0]).args[0] or go(env, a[1]).args[0])
        if t == "if":
            return go(env, a[1]) if go(env, a[0]).args[0] else go(env, a[2])
        if t == "eq":
            return v_bool(go(env, a[0]) == go(env, a[1]))
        if t == "to_field":
            v = go(env, a[0])
            if v.tag == "field":
                return v
            if v.tag == "bool":
                return v_field(Fr(1) if v.args[0] else Fr(0))
            if v.tag == "uint32":
                return v_field(f_of_uint32(v.args[0]))
            raise TypeError("to_field of compound value")
        if t == "let":
            v, bound, body = a
            return go({**env, v: go(env, bound)}, body)
        if t == "var":
            return env[a[0]]
        if t == "pair":
            return v_pair(go(env, a[0]), go(env, a[1]))
        if t == "fst":
            return go(env, a[0]).args[0]
        if t == "snd":
            return go(env, a[0]).args[1]
        if t == "left":
            return v_left(go(env, a[0]))
        if t == "right":
            return v_right(go(env, a[0]))
        if t == "case":
            ab, va, ea, vb, eb = a
            v = go(env, ab)
            if v.tag == "left":
                return go({**env, va: v.args[0]}, ea)
            assert v.tag == "right"
            return go({**env, vb: v.args[0]}, eb)
        if t == "check_u32":
            v = go(env, a[0])
            assert v.tag == "uint32" and 0 <= v.args[0] < (1 << 32)
            return v
        if t == "add_u32":
            x = go(env, a[0]).args[0]
            y = go(env, a[1]).args[0]
            return v_uint32((x + y) % (1 << 32))
        if t == "sub_u32":
            x = go(env, a[0]).args[0]
            y = go(env, a[1]).args[0]
            return v_uint32((x - y) % (1 << 32))
        raise ValueError(f"unknown expr tag {t}")

    return go({}, e)


def compile_value(ty: Type, v: Value):
    """Flatten a typed value into its field-vector representation
    (comp.ml:130-146): Left tag=0 / Right tag=1, zero-padded to the
    components width."""
    if v.tag == "field":
        return [v.args[0]]
    if v.tag == "bool":
        return [Fr(1) if v.args[0] else Fr(0)]
    if v.tag == "uint32":
        return [f_of_uint32(v.args[0])]
    if v.tag == "pair":
        assert isinstance(ty, TPair)
        return compile_value(ty.t1, v.args[0]) + compile_value(ty.t2, v.args[1])
    if v.tag == "left":
        assert isinstance(ty, TEither)
        cs = ty.components() - 1
        fs = compile_value(ty.t1, v.args[0])
        return [Fr(0)] + fs + [Fr(0)] * (cs - len(fs))
    if v.tag == "right":
        assert isinstance(ty, TEither)
        cs = ty.components() - 1
        fs = compile_value(ty.t2, v.args[0])
        return [Fr(1)] + fs + [Fr(0)] * (cs - len(fs))
    raise TypeError(v)
