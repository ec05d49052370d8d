"""Synthetic wide witness programs for the levelized evaluator's checks.

`wide_program(lanes, levels, seed)` builds `lanes` independent lanes of
straight-line `Code`, one step a lane a level, over `lanes` secret inputs
and ONE: `lanes * levels` steps in `levels` levels.  The first eight
levels hold every kind the evaluator has, one kind a level:

  1 affine   a = c1 x_i + c2 x_j + c3 ONE
  2 mul      m = a_i * a_j
  3 eq       e = (m_i == m_i) or (m_i == m_j): half the lanes 1
  4 not      n = not e
  5 or       o = n_i or n_j: about a quarter of the lanes 0
  6 mul      d = o * m: zero exactly where o is 0
  7 div      a / d, nested in the `if` below, not a variable of its own
  8 if       if o then a / d else m

so a quarter of the lanes divide by zero in the branch their `if` does
not take: the lazy evaluator never evaluates those divisions, and the
levelized one must track their poison and drop it.  Levels 9 on
alternate affine (three terms over the previous level, any earlier level
and ONE) and mul.  Coefficients and inputs are random field elements from
`seed`.  Test scaffolding, as `suites.py` is.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from .. import params
from ..core import comp, var as var_mod
from ..core.circuit import ONE, Affine
from ..core.var import Var
from ..golden.field import Fr

FIRST_KINDS = ("affine", "mul", "eq", "not", "or", "mul", "div", "if")


def _aff(terms) -> comp.Code:
    return comp.c_aff(Affine(dict(terms)))


def _ref(v: Var) -> comp.Code:
    return comp.c_aff(Affine.of_var(v, Fr))


def wide_program(lanes: int, levels: int, seed: int = 0
                 ) -> Tuple[List[Tuple[Var, comp.Code]], Dict[Var, Fr]]:
    """-> (codes, env): the Code list and its inputs (the secrets and ONE)."""
    if levels < len(FIRST_KINDS):
        raise ValueError(f"wide_program: at least {len(FIRST_KINDS)} levels "
                         "(one for each kind)")
    rng = random.Random(seed)

    def fr() -> Fr:
        return Fr(rng.randrange(1, params.R))

    def other(i: int) -> int:
        return (i + rng.randrange(1, lanes)) % lanes

    xs = [var_mod.make("x") for _ in range(lanes)]
    env = {x: fr() for x in xs}
    env[ONE] = Fr(1)
    codes: List[Tuple[Var, comp.Code]] = []

    def level(make) -> List[Var]:
        out = []
        for i in range(lanes):
            v = var_mod.make("w")
            codes.append((v, make(i)))
            out.append(v)
        return out

    a = level(lambda i: _aff([(xs[i], fr()), (xs[other(i)], fr()),
                              (ONE, fr())]))
    m = level(lambda i: comp.c_mul(_ref(a[i]), _ref(a[other(i)])))
    e = level(lambda i: comp.c_eq(_ref(m[i]), _ref(
        m[i] if rng.random() < 0.5 else m[other(i)])))
    n = level(lambda i: comp.c_not(_ref(e[i])))
    o = level(lambda i: comp.c_or(_ref(n[i]), _ref(n[other(i)])))
    d = level(lambda i: comp.c_mul(_ref(o[i]), _ref(m[i])))
    prev = level(lambda i: comp.c_if(_ref(o[i]),
                                     comp.c_div(_ref(a[i]), _ref(d[i])),
                                     _ref(m[i])))
    earlier = a + m + d + prev
    for k in range(levels - len(FIRST_KINDS)):
        p = prev
        if k % 2 == 0:
            prev = level(lambda i: _aff([(p[i], fr()),
                                         (rng.choice(earlier), fr()),
                                         (ONE, fr())]))
        else:
            prev = level(lambda i: comp.c_mul(_ref(p[i]), _ref(p[other(i)])))
        earlier += prev
    return codes, env
