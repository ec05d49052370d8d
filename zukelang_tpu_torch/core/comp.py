"""DSL -> circuit compiler + straight-line witness-generation code.

The port's own copy of `zukelang_tpu/core/comp.py`.

Mirrors `Comp.Make(F)` (src/lib/zk/comp.ml): one traversal of the typed
expression emits (a) multiplication gates and (b) a straight-line `Code`
program that *computes* every intermediate wire value, so proving needs no
constraint solver — just sequential Code evaluation (comp.ml:114-122).

Gadget algebra follows comp.ml:194-444 construct by construct (Mul/Div/Not/
Or/If/Eq/Pair/Either/uint32), with two deliberate divergences from the
reference, both latent bugs there that its randomized tests cannot trigger:

  * Div constant folding (comp.ml:248-251) multiplies instead of dividing;
    we fold to the mathematically correct a/b and a*(1/b).
  * The Case join (comp.ml:421-437) computes (tag-1)*c + tag*d which yields
    -c for Left arms; we emit (1-tag)*c + tag*d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..golden.field import Fr
from . import lang as L
from . import var as var_mod
from .circuit import ONE, Affine, Circuit, Gate, gates_vars, sort_gates
from .var import Var


def _aff_var(v: Var) -> Affine:
    return Affine.of_var(v, Fr)


def _aff_int(i: int) -> Affine:
    return Affine.of_F(Fr(i))


# ---------------------------------------------------------------------------
# Code: the witness-generation mini-language (comp.ml:19-123)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Code:
    tag: str  # mul | div | not | or | affine | eq | if
    args: Tuple[Any, ...]

    def __repr__(self):
        t, a = self.tag, self.args
        if t == "affine":
            return repr(a[0])
        if t in ("mul", "div", "or", "eq"):
            op = {"mul": "*", "div": "/", "or": "||", "eq": "=="}[t]
            return f"({a[0]!r} {op} {a[1]!r})"
        if t == "not":
            return f"(not {a[0]!r})"
        return f"(if {a[0]!r} then {a[1]!r} else {a[2]!r})"


def c_mul(a, b):
    return Code("mul", (a, b))


def c_div(a, b):
    return Code("div", (a, b))


def c_not(a):
    return Code("not", (a,))


def c_or(a, b):
    return Code("or", (a, b))


def c_aff(a: Affine):
    return Code("affine", (a,))


def c_eq(a, b):
    return Code("eq", (a, b))


def c_if(a, b, c):
    return Code("if", (a, b, c))


def c_u32_bit(a, i: int):
    """Bit i of the discrete log of a 2^32-torsion value (the uint32
    embedding's exponent) — host-side Pohlig-Hellman during witness gen;
    raises on values outside the torsion (no valid witness exists)."""
    return Code("u32bit", (a, i))


def code_eval(env: Dict[Var, Fr], c: Code) -> Fr:
    """comp.ml:71-112; booleans are 0/1 field values, Div raises on zero."""
    t, a = c.tag, c.args

    def to_bool(f: Fr) -> bool:
        if f.is_zero():
            return False
        if f == Fr(1):
            return True
        raise AssertionError("non-boolean field value in Code")

    if t == "mul":
        return code_eval(env, a[0]) * code_eval(env, a[1])
    if t == "div":
        x, y = code_eval(env, a[0]), code_eval(env, a[1])
        if y.is_zero():
            raise ZeroDivisionError("Code division by zero")
        return x / y
    if t == "not":
        return Fr(0) if to_bool(code_eval(env, a[0])) else Fr(1)
    if t == "or":
        x = to_bool(code_eval(env, a[0]))
        y = to_bool(code_eval(env, a[1]))
        return Fr(1) if (x or y) else Fr(0)
    if t == "eq":
        return Fr(1) if code_eval(env, a[0]) == code_eval(env, a[1]) else Fr(0)
    if t == "if":
        return code_eval(env, a[1]) if to_bool(code_eval(env, a[0])) else code_eval(env, a[2])
    if t == "affine":
        return a[0].eval(env, Fr)
    if t == "u32bit":
        from .. import params
        from . import roots
        y = code_eval(env, a[0])
        x = roots.uint_of_f(params.R, 32, y.n)
        if x is None:
            raise AssertionError(
                "check_u32: value is not a uint32 embedding")
        return Fr((x >> a[1]) & 1)
    raise ValueError(t)


def code_eval_list(env: Dict[Var, Fr], codes: List[Tuple[Var, Code]]) -> Dict[Var, Fr]:
    """Sequential witness generation (comp.ml:114-122)."""
    env = dict(env)
    for v, c in codes:
        if v in env:
            raise AssertionError(f"duplicate witness assignment {v}")
        env[v] = code_eval(env, c)
    return env


# ---------------------------------------------------------------------------
# Compilation state (GateM, comp.ml:148-192)
# ---------------------------------------------------------------------------

class _State:
    def __init__(self):
        self.gates: set = set()
        self.inputs: Dict[str, Tuple[str, L.Type, List[Var]]] = {}
        self.rev_codes: List[Tuple[Var, Code]] = []

    def add_gate(self, lhs: Affine, l: Affine, r: Affine):
        self.gates.add(Gate(lhs, l, r))

    def add_one(self):
        if "$ONE" not in self.inputs:
            self.inputs["$ONE"] = (L.PUBLIC, L.ty_field, [ONE])

    def add_input(self, name: str, sec: str, ty: L.Type) -> List[Affine]:
        assert name != "$ONE"
        if name in self.inputs:
            raise ValueError(f"duplicated input name {name}")
        vs = [var_mod.make(name) for _ in range(ty.components())]
        self.inputs[name] = (sec, ty, vs)
        return [_aff_var(v) for v in vs]

    def add_code(self, v: Var, c: Code):
        if any(v0 == v for v0, _ in self.rev_codes):
            raise AssertionError(f"duplicate code for {v}")
        self.rev_codes.append((v, c))


def _fresh() -> Tuple[Var, Affine]:
    v = var_mod.make("c")
    return v, _aff_var(v)


# ---------------------------------------------------------------------------
# The compiler (comp.ml:194-444)
# ---------------------------------------------------------------------------

def _compile(st: _State, env, e: L.Expr) -> List[Affine]:
    t, a = e.tag, e.args

    def one(x: L.Expr) -> Affine:
        res = _compile(st, env, x)
        assert len(res) == 1
        return res[0]

    if t == "field":
        st.add_one()
        return [Affine.of_F(a[0])]
    if t == "bool":
        return [_aff_int(1 if a[0] else 0)]
    if t == "uint32":
        return [Affine.of_F(L.f_of_uint32(a[0]))]
    if t == "input":
        return st.add_input(a[0], a[1], e.ty)
    if t == "add":
        return [one(a[0]).add(one(a[1]))]
    if t == "sub":
        return _compile(st, env, L.add(a[0], L.neg(a[1])))
    if t == "neg":
        return [one(a[0]).mul_scalar(Fr(-1))]
    if t == "mul":
        t1, t2 = one(a[0]), one(a[1])
        c1, c2 = t1.is_const(Fr), t2.is_const(Fr)
        if c1 is not None and c2 is not None:
            return [Affine.of_F(c1 * c2)]
        if c1 is not None:
            return [t2.mul_scalar(c1)]
        if c2 is not None:
            return [t1.mul_scalar(c2)]
        va, av = _fresh()
        st.add_code(va, c_mul(c_aff(t1), c_aff(t2)))
        st.add_gate(av, t1, t2)
        return [av]
    if t == "div":
        ta, tb = one(a[0]), one(a[1])
        ca, cb = ta.is_const(Fr), tb.is_const(Fr)
        if ca is not None and cb is not None:
            # reference bug here (comp.ml:249 folds to a*b); we fold to a/b
            return [Affine.of_F(ca / cb)]
        if cb is not None:
            # a / const  ==  a * const^-1  (reference folds to a*b, comp.ml:251)
            return [ta.mul_scalar(cb.inv())]
        # general: d  where  1 = b*c  and  d = a*c   (comp.ml:253-264)
        vc, cv = _fresh()
        vd, dv = _fresh()
        st.add_code(vc, c_div(c_aff(_aff_int(1)), c_aff(tb)))
        st.add_code(vd, c_mul(c_aff(ta), c_aff(cv)))
        st.add_one()
        st.add_gate(_aff_int(1), tb, cv)
        st.add_gate(dv, ta, cv)
        return [dv]
    if t == "not":
        if a[0].tag == "bool":
            return _compile(st, env, L.boolean(not a[0].args[0]))
        # b  where  0 = a*b  and  1 = (a+b)*1   (comp.ml:266-278)
        av = one(a[0])
        vb, bv = _fresh()
        st.add_code(vb, c_not(c_aff(av)))
        st.add_one()
        st.add_gate(_aff_int(0), av, bv)
        st.add_gate(_aff_int(1), av.add(bv), _aff_int(1))
        return [bv]
    if t == "and":
        return _compile(st, env, L.mul(L.to_field(a[0]), L.to_field(a[1])))
    if t == "or":
        # c  where  c = (a+b)*d  and  0 = (a+b)*(1-c)   (comp.ml:281-297)
        av, bv = one(a[0]), one(a[1])
        vc, cv = _fresh()
        vd, dv = _fresh()
        a_plus_b = av.add(bv)
        st.add_one()
        st.add_code(vc, c_or(c_aff(av), c_aff(bv)))
        st.add_code(vd, c_if(c_aff(cv), c_div(c_aff(_aff_int(1)), c_aff(a_plus_b)),
                             c_aff(_aff_int(0))))
        st.add_gate(cv, a_plus_b, dv)
        st.add_gate(_aff_int(0), a_plus_b, _aff_int(1).sub(cv))
        return [cv]
    if t == "if":
        # a*(b-c)+c  via  d = a*(b-c)  per component  (comp.ml:298-324)
        av = one(a[0])
        ca = av.is_const(Fr)
        if ca is not None:
            return _compile(st, env, a[1] if ca == Fr(1) else a[2])
        bs = _compile(st, env, a[1])
        cs = _compile(st, env, a[2])
        out = []
        for bv, cv in zip(bs, cs):
            vd, dv = _fresh()  # allocated even when folded, like comp.ml:315
            b_c = bv.sub(cv)
            cbc = b_c.is_const(Fr)
            if cbc is not None:
                out.append(cv.add(av.mul_scalar(cbc)))
            else:
                st.add_code(vd, c_mul(c_aff(av), c_aff(b_c)))
                st.add_gate(dv, av, b_c)
                out.append(cv.add(dv))
        return out
    if t == "eq":
        # c  where  1-c = (a-b)*d  and  0 = (a-b)*c  per component, then a
        # conjunction chain (comp.ml:325-374)
        as_ = _compile(st, env, a[0])
        bs_ = _compile(st, env, a[1])
        cs = []
        for av, bv in zip(as_, bs_):
            vc, cv = _fresh()
            vd, dv = _fresh()
            st.add_one()
            st.add_code(vc, c_eq(c_aff(av), c_aff(bv)))
            st.add_code(vd, c_if(c_aff(cv), c_aff(_aff_int(0)),
                                 c_div(c_aff(_aff_int(1)), c_aff(av.sub(bv)))))
            st.add_gate(_aff_int(1).sub(cv), av.sub(bv), dv)
            st.add_gate(_aff_int(0), av.sub(bv), cv)
            cs.append(cv)
        acc = cs[0]
        for cv in cs[1:]:
            vx, xv = _fresh()
            st.add_code(vx, c_mul(c_aff(acc), c_aff(cv)))
            st.add_gate(xv, acc, cv)
            acc = xv
        return [acc]
    if t == "to_field":
        return _compile(st, env, a[0])
    if t == "let":
        v, bound, body = a
        avs = _compile(st, env, bound)
        return _compile(st, [(v, avs)] + env, body)
    if t == "var":
        for v0, avs in env:
            if v0 == a[0]:
                return avs
        raise KeyError(a[0])
    if t == "pair":
        return _compile(st, env, a[0]) + _compile(st, env, a[1])
    if t == "fst":
        cs = a[0].ty.t1.components()
        return _compile(st, env, a[0])[:cs]
    if t == "snd":
        cs = a[0].ty.t1.components()
        return _compile(st, env, a[0])[cs:]
    if t == "left":
        return [_aff_int(0)] + _compile(st, env, a[0])
    if t == "right":
        avs = _compile(st, env, a[0])
        st.add_one()
        return [_aff_int(1)] + avs
    if t == "case":
        # (1-tag)*c + tag*d per component  (comp.ml:412-440, sign fixed)
        ab, va, ce, vb, de = a
        aty, bty = ab.ty.t1, ab.ty.t2
        abv = _compile(st, env, ab)
        tag = abv[0]
        for_a = abv[1:aty.components() + 1]
        for_b = abv[1:bty.components() + 1]
        cs = _compile(st, [(va, for_a)] + env, ce)
        ds = _compile(st, [(vb, for_b)] + env, de)
        st.add_one()
        out = []
        one_minus_tag = _aff_int(1).sub(tag)
        for cv, dv in zip(cs, ds):
            vx, xv = _fresh()
            vy, yv = _fresh()
            st.add_code(vx, c_mul(c_aff(one_minus_tag), c_aff(cv)))
            st.add_gate(xv, one_minus_tag, cv)
            st.add_code(vy, c_mul(c_aff(tag), c_aff(dv)))
            st.add_gate(yv, tag, dv)
            out.append(xv.add(yv))
        return out
    if t == "check_u32":
        av = one(a[0])
        cst = av.is_const(Fr)
        if cst is not None:
            from .. import params
            from . import roots
            if roots.uint_of_f(params.R, 32, cst.n) is None:
                raise ValueError("check_u32 on an invalid uint32 constant")
            return [av]
        st.add_one()
        # 32 witness bits b_i with booleanity gates 0 = b_i * (b_i - 1),
        # then a product chain  omega^x = prod_i (1 + b_i (omega^(2^i)-1))
        # pinned to the checked wire by the last gate's lhs.
        bits = []
        for i in range(32):
            vb, bv = _fresh()
            st.add_code(vb, c_u32_bit(c_aff(av), i))
            st.add_gate(_aff_int(0), bv, bv.add(_aff_int(-1)))
            bits.append(bv)

        def factor(i: int) -> Affine:
            w = L.f_of_uint32(1 << i)  # omega^(2^i)
            return _aff_int(1).add(bits[i].mul_scalar(w - Fr(1)))

        acc = factor(0)
        for i in range(1, 31):
            vt, tv = _fresh()
            st.add_code(vt, c_mul(c_aff(acc), c_aff(factor(i))))
            st.add_gate(tv, acc, factor(i))
            acc = tv
        st.add_gate(av, acc, factor(31))
        return [av]
    if t == "add_u32":
        # omega^a * omega^b = omega^(a+b mod 2^32)  (comp.ml:441-442)
        return _compile(st, env, L.mul(L.to_field(a[0]), L.to_field(a[1])))
    if t == "sub_u32":
        return _compile(st, env, L.div(L.to_field(a[0]), L.to_field(a[1])))
    raise ValueError(f"cannot compile {t}")


def _fix_output(st: _State, a: Affine) -> Affine:
    """Alias non-trivial output affines through a fresh gate (comp.ml:448-473)."""
    items = sorted(a.m.items())
    if not items:
        return a
    if len(items) == 1:
        v, f = items[0]
        if v == ONE:
            return a
        if f == Fr(1):
            return a
    vo = var_mod.make("v")
    o = _aff_var(vo)
    st.add_code(vo, c_aff(a))
    st.add_one()
    st.add_gate(o, a, _aff_int(1))
    return o


@dataclass
class Compiled:
    """Result record (comp.ml:479-488)."""
    gates: List[Gate]
    inputs: Dict[str, Tuple[str, L.Type, List[Var]]]
    inputs_vars: Dict[Var, str]          # var -> security
    mids: set
    outputs: set
    codes: List[Tuple[Var, Code]]
    result: List[Affine]
    circuit: Circuit
    ty: L.Type


def compile_expr(e: L.Expr) -> Compiled:
    """Full compilation driver (comp.ml:491-530)."""
    st = _State()
    result = _compile(st, [], e)
    result = [_fix_output(st, a) for a in result]

    gates = sort_gates(st.gates)
    gvars = gates_vars(gates)

    inputs_vars: Dict[Var, str] = {}
    for name in sorted(st.inputs):
        sec, _ty, vs = st.inputs[name]
        for v in vs:
            if v in gvars:
                inputs_vars[v] = sec

    outputs = set()
    for a in result:
        items = list(a.m.items())
        if len(items) == 1 and items[0][0] != ONE:
            outputs.add(items[0][0])
        elif len(items) == 0:
            pass
        else:
            raise AssertionError("fix_output failed to normalize an output")

    mids = gvars - set(inputs_vars) - outputs

    inputs_public = {v for v, sec in inputs_vars.items() if sec == L.PUBLIC}
    circuit_mids = mids | (gvars - inputs_public - outputs)
    circuit = Circuit(gates, inputs_public, outputs, circuit_mids)

    return Compiled(
        gates=gates,
        inputs=dict(st.inputs),
        inputs_vars=inputs_vars,
        mids=mids,
        outputs=outputs,
        codes=list(st.rev_codes),
        result=result,
        circuit=circuit,
        ty=e.ty,
    )


# ---------------------------------------------------------------------------
# Input preparation (comp.ml:532-567)
# ---------------------------------------------------------------------------

def gen_inputs(inputs, rng):
    """Random typed inputs; returns (inputs_with_values, env_lang, env_code)."""
    out = {}
    for name in sorted(inputs):
        sec, ty, vs = inputs[name]
        if name == "$ONE":
            value = L.v_field(Fr(1))
        else:
            value = L.gen_value(ty, rng)
        flat = L.compile_value(ty, value)
        out[name] = (sec, value, list(zip(vs, flat)))
    env_lang = {name: v for name, (_s, v, _b) in out.items()}
    env_code = {v: f for (_s, _v, binds) in out.values() for v, f in binds}
    return out, env_lang, env_code


def convert_inputs(inputs, values: Dict[str, L.Value]):
    """Bind caller-supplied values to input variables."""
    out = {}
    for name in sorted(inputs):
        sec, ty, vs = inputs[name]
        if name == "$ONE":
            value = L.v_field(Fr(1))
        elif name in values:
            value = values[name]
        else:
            raise ValueError(f"input not defined: {name}")
        flat = L.compile_value(ty, value)
        out[name] = (sec, value, list(zip(vs, flat)))
    env_code = {v: f for (_s, _v, binds) in out.values() for v, f in binds}
    return out, env_code
