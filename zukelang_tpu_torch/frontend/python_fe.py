"""Python-syntax front end: write ZK programs as ordinary Python functions.

The port's own copy of `zukelang_tpu/frontend/python_fe.py`.

The analog of the reference's second front end, which reuses the real OCaml
typechecker to lower OCaml syntax into the Lang GADT
(src/lib/syntax/trans.ml, typecheck.ml).  Here the host language is Python:
a restricted function body is parsed with `ast`, type-checked by a small
bidirectional checker (annotations on secret/public bindings play the role
the OCaml typechecker's environment plays at trans.ml:247-260), and lowered
to the same core Expr the combinator DSL builds.

Type mapping (trans.ml:19-44 equivalents):
    int            -> field
    bool           -> bool
    u32            -> uint32
    tuple[a, b]    -> pair
    Either[a, b]   -> either (constructed with Left(x) / Right(x))

Supported body: a sequence of (optionally annotated) assignments, `match`
on Either, conditional expressions, and a final `return`.

Example:
    def prog():
        x: int = secret("input")
        return x * x * x + x + 3
    e = compile_python(prog)
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass

from ..core import lang as L


# -- markers usable inside user programs (never executed) -------------------

class Either:
    def __class_getitem__(cls, item):
        return cls


class u32:
    pass


def secret(name):  # pragma: no cover - marker
    raise RuntimeError("secret() is a DSL marker; compile the function instead")


def public(name):  # pragma: no cover - marker
    raise RuntimeError("public() is a DSL marker; compile the function instead")


def Left(x):  # pragma: no cover - marker
    raise RuntimeError("Left() is a DSL marker")


def Right(x):  # pragma: no cover - marker
    raise RuntimeError("Right() is a DSL marker")


class FrontendError(TypeError):
    pass


# -- type algebra with holes -------------------------------------------------

HOLE = None  # unknown type


def unify(a, b):
    if a is HOLE:
        return b
    if b is HOLE:
        return a
    if type(a) is not type(b):
        raise FrontendError(f"type mismatch: {a!r} vs {b!r}")
    if isinstance(a, (L.TField, L.TBool, L.TUint32)):
        return a
    if isinstance(a, L.TPair):
        return L.TPair(unify(a.t1, b.t1), unify(a.t2, b.t2))
    if isinstance(a, L.TEither):
        return L.TEither(unify(a.t1, b.t1), unify(a.t2, b.t2))
    raise FrontendError(f"cannot unify {a!r} and {b!r}")


def _no_holes(t):
    if t is HOLE:
        return False
    if isinstance(t, (L.TPair, L.TEither)):
        return _no_holes(t.t1) and _no_holes(t.t2)
    return True


def _ann_to_type(node: ast.expr):
    """Annotation AST -> Lang type (trans.ml:19-44 mapping)."""
    if isinstance(node, ast.Name):
        if node.id == "int":
            return L.ty_field
        if node.id == "bool":
            return L.ty_bool
        if node.id == "u32":
            return L.ty_uint32
        raise FrontendError(f"unsupported annotation {node.id}")
    if isinstance(node, ast.Tuple):
        elts = node.elts
        if len(elts) != 2:
            raise FrontendError("only 2-tuples are supported")
        return L.ty_pair(_ann_to_type(elts[0]), _ann_to_type(elts[1]))
    if isinstance(node, ast.Subscript):
        base = node.value
        if isinstance(base, ast.Name) and base.id in ("Either", "tuple", "Tuple"):
            sl = node.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            if len(elts) != 2:
                raise FrontendError("Either/tuple annotations take 2 args")
            t1, t2 = _ann_to_type(elts[0]), _ann_to_type(elts[1])
            if base.id == "Either":
                return L.ty_either(t1, t2)
            return L.ty_pair(t1, t2)
    raise FrontendError(f"unsupported annotation {ast.dump(node)}")


# -- the translator ----------------------------------------------------------

@dataclass
class _Binding:
    expr: L.Expr


class _Translator:
    def __init__(self):
        self.env = {}

    # expressions ----------------------------------------------------------
    def expr(self, node: ast.expr, expected=HOLE) -> L.Expr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return L.boolean(node.value)
            if isinstance(node.value, int):
                if isinstance(expected, L.TUint32):
                    return L.uint32(node.value)
                return L.fnum(node.value)
            raise FrontendError(f"unsupported constant {node.value!r}")

        if isinstance(node, ast.Name):
            if node.id not in self.env:
                raise FrontendError(f"unbound variable {node.id}")
            return self.env[node.id].expr

        if isinstance(node, ast.BinOp):
            # arithmetic defaults to the field type (like OCaml's int ops,
            # trans.ml:139-184); an already-typed uint32 operand overrides.
            op_expected = expected if expected is not HOLE else L.ty_field
            lt = self.expr(node.left, op_expected)
            rt = self.expr(node.right, op_expected)
            if isinstance(lt.ty, L.TUint32) or isinstance(rt.ty, L.TUint32):
                if isinstance(node.op, ast.Add):
                    return L.add_u32(lt, rt)
                if isinstance(node.op, ast.Sub):
                    return L.sub_u32(lt, rt)
                raise FrontendError("uint32 supports only + and -")
            ops = {ast.Add: L.add, ast.Sub: L.sub, ast.Mult: L.mul,
                   ast.Div: L.div}
            for k, f in ops.items():
                if isinstance(node.op, k):
                    return f(lt, rt)
            raise FrontendError(f"unsupported operator {node.op}")

        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return L.neg(self.expr(node.operand))
            if isinstance(node.op, ast.Not):
                return L.not_(self.expr(node.operand))
            raise FrontendError("unsupported unary op")

        if isinstance(node, ast.BoolOp):
            f = L.and_ if isinstance(node.op, ast.And) else L.or_
            acc = self.expr(node.values[0])
            for v in node.values[1:]:
                acc = f(acc, self.expr(v))
            return acc

        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or not isinstance(node.ops[0], ast.Eq):
                raise FrontendError("only == comparisons are supported")
            a = self.expr(node.left)
            b = self.expr(node.comparators[0])
            return L.eq(a, b)

        if isinstance(node, ast.IfExp):
            c = self.expr(node.test)
            a = self.expr(node.body, expected)
            b = self.expr(node.orelse, expected)
            ty = unify(unify(a.ty, b.ty), expected)
            a = _retype(a, ty)
            b = _retype(b, ty)
            return L.if_(c, a, b)

        if isinstance(node, ast.Tuple):
            if len(node.elts) != 2:
                raise FrontendError("only 2-tuples are supported")
            a = self.expr(node.elts[0],
                          expected.t1 if isinstance(expected, L.TPair) else HOLE)
            b = self.expr(node.elts[1],
                          expected.t2 if isinstance(expected, L.TPair) else HOLE)
            return L.pair(a, b)

        if isinstance(node, ast.Subscript):
            base = self.expr(node.value)
            if not isinstance(base.ty, L.TPair):
                raise FrontendError("indexing requires a pair")
            if isinstance(node.slice, ast.Constant) and node.slice.value in (0, 1):
                return L.fst(base) if node.slice.value == 0 else L.snd(base)
            raise FrontendError("only [0] / [1] indexing is supported")

        if isinstance(node, ast.Call):
            return self.call(node, expected)

        raise FrontendError(f"unsupported expression {ast.dump(node)[:80]}")

    def call(self, node: ast.Call, expected):
        fn = node.func
        name = None
        if isinstance(fn, ast.Name):
            name = fn.id
        elif isinstance(fn, ast.Attribute):
            # Either.Left(x) etc.
            name = fn.attr
        if name in ("secret", "public"):
            if len(node.args) != 1 or not isinstance(node.args[0], ast.Constant):
                raise FrontendError("secret/public take one literal name")
            if not _no_holes(expected):
                raise FrontendError(
                    "secret/public bindings need a type annotation")
            sec = L.SECRET if name == "secret" else L.PUBLIC
            return L.input(node.args[0].value, sec, expected)
        if name == "Left":
            inner_exp = expected.t1 if isinstance(expected, L.TEither) else HOLE
            a = self.expr(node.args[0], inner_exp)
            other = expected.t2 if isinstance(expected, L.TEither) else HOLE
            return L.Expr("left", (a,), L.TEither(a.ty, other))
        if name == "Right":
            inner_exp = expected.t2 if isinstance(expected, L.TEither) else HOLE
            b = self.expr(node.args[0], inner_exp)
            other = expected.t1 if isinstance(expected, L.TEither) else HOLE
            return L.Expr("right", (b,), L.TEither(other, b.ty))
        if name == "fst":
            return L.fst(self.expr(node.args[0]))
        if name == "snd":
            return L.snd(self.expr(node.args[0]))
        if name == "to_field":
            return L.to_field(self.expr(node.args[0]))
        if name == "check_u32":
            a = self.expr(node.args[0], L.ty_uint32)
            if not isinstance(a.ty, L.TUint32):
                raise FrontendError("check_u32 needs a uint32 argument")
            return L.check_u32(a)
        raise FrontendError(f"unsupported call {name}")

    # statements -----------------------------------------------------------
    def body(self, stmts) -> L.Expr:
        if not stmts:
            raise FrontendError("empty body")
        st = stmts[0]
        rest = stmts[1:]

        if isinstance(st, ast.Return):
            if rest:
                raise FrontendError("code after return")
            e = self.expr(st.value)
            if not _no_holes(e.ty):
                raise FrontendError(f"could not infer full type {e.ty!r}")
            return e

        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            if isinstance(st, ast.Assign):
                if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
                    raise FrontendError("only simple assignments")
                name = st.targets[0].id
                expected = HOLE
            else:
                if not isinstance(st.target, ast.Name):
                    raise FrontendError("only simple assignments")
                name = st.target.id
                expected = _ann_to_type(st.annotation)
            bound = self.expr(st.value, expected)
            if expected is not HOLE:
                bound = _retype(bound, unify(bound.ty, expected))
            saved = self.env.get(name)
            from ..core import var as var_mod
            vv = var_mod.make(name)
            self.env[name] = _Binding(L.var(vv, bound.ty))
            body_expr = self.body(rest)
            if saved is None:
                del self.env[name]
            else:
                self.env[name] = saved
            return L.Expr("let", (vv, bound, body_expr), body_expr.ty)

        if isinstance(st, ast.Match):
            if rest:
                raise FrontendError("match must be the final statement")
            return self.match(st)

        if isinstance(st, ast.If):
            # if/else where both arms return
            def arm(stmts):
                return self.body(stmts)
            if not st.orelse:
                raise FrontendError("if statements need an else arm")
            c = self.expr(st.test)
            a = arm(st.body)
            b = arm(st.orelse)
            ty = unify(a.ty, b.ty)
            return L.if_(c, _retype(a, ty), _retype(b, ty))

        raise FrontendError(f"unsupported statement {type(st).__name__}")

    def match(self, st: ast.Match) -> L.Expr:
        subj = self.expr(st.subject)
        if not isinstance(subj.ty, L.TEither):
            raise FrontendError("match requires an Either subject")
        left_case = right_case = None
        for case in st.cases:
            pat = case.pattern
            if not isinstance(pat, ast.MatchClass) or not isinstance(pat.cls, (ast.Name, ast.Attribute)):
                raise FrontendError("patterns must be Left(x) / Right(x)")
            cname = pat.cls.id if isinstance(pat.cls, ast.Name) else pat.cls.attr
            if len(pat.patterns) != 1:
                raise FrontendError("Left/Right take one argument")
            p0 = pat.patterns[0]
            if isinstance(p0, ast.MatchAs):
                bind_name = p0.name  # may be None for _
            else:
                raise FrontendError("pattern argument must be a name")
            if cname == "Left":
                left_case = (bind_name, case.body)
            elif cname == "Right":
                right_case = (bind_name, case.body)
            else:
                raise FrontendError(f"unknown pattern {cname}")
        if left_case is None or right_case is None:
            raise FrontendError("match needs both Left and Right cases")

        from ..core import var as var_mod

        def make_arm(bind, body_stmts, ty):
            vv = var_mod.make(bind or "_case")
            saved = self.env.get(bind) if bind else None
            if bind:
                self.env[bind] = _Binding(L.var(vv, ty))
            e = self.body(body_stmts)
            if bind:
                if saved is None:
                    del self.env[bind]
                else:
                    self.env[bind] = saved
            return vv, e

        va, ea = make_arm(left_case[0], left_case[1], subj.ty.t1)
        vb, eb = make_arm(right_case[0], right_case[1], subj.ty.t2)
        ty = unify(ea.ty, eb.ty)
        return L.Expr("case", (subj, va, _retype(ea, ty), vb, _retype(eb, ty)), ty)


def _retype(e: L.Expr, ty) -> L.Expr:
    """Resolve hole types in an expression against a concrete type."""
    if e.ty == ty or not _no_holes(ty):
        return e
    if isinstance(ty, L.TEither) and e.tag in ("left", "right"):
        return L.Expr(e.tag, e.args, ty)
    if isinstance(ty, L.TPair) and e.tag == "pair":
        return L.Expr("pair",
                      (_retype(e.args[0], ty.t1), _retype(e.args[1], ty.t2)),
                      ty)
    if e.tag == "if":
        return L.Expr("if", (e.args[0], _retype(e.args[1], ty),
                             _retype(e.args[2], ty)), ty)
    if e.tag == "let":
        return L.Expr("let", (e.args[0], e.args[1], _retype(e.args[2], ty)), ty)
    # other node kinds already have concrete types
    return e


def compile_python(fn_or_source) -> L.Expr:
    """Compile a Python function (object or source string) to a Lang Expr."""
    if isinstance(fn_or_source, str):
        source = fn_or_source
    else:
        source = textwrap.dedent(inspect.getsource(fn_or_source))
    tree = ast.parse(source)
    fndefs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(fndefs) != 1:
        raise FrontendError("expected exactly one function definition")
    tr = _Translator()
    return tr.body(fndefs[0].body)
