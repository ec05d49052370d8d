"""Levelized batched witness generation.

The port's own copy of `zukelang_tpu/core/witness.py`.

The reference generates witnesses by evaluating straight-line `Code`
sequentially (comp.ml:114-122); core.comp.code_eval_list mirrors that.
For wide circuits that is a long chain of Python big-int operations.  This
module compiles the Code list ONCE into a level-scheduled array program:

  * every Code subtree becomes a primitive step (affine / mul / div / not /
    or / eq / if) writing one slot of a value table,
  * steps are scheduled by dependency level; within a level, steps of the
    same kind evaluate as ONE batched field operation on limb tensors
    (`ops.field`: K1 for the products on a CUDA tensor, its plain version
    on the CPU), between one gather of the operands and one scatter of
    the results,
  * the reference's *lazy* semantics survive eager evaluation through
    poison tracking: `div` marks its output poisoned when the denominator
    is zero, `if` propagates only the taken branch's poison, and a
    poisoned assigned wire reproduces code_eval_list's ZeroDivisionError
    (the harness' resample-and-retry contract, test.ml:148-150).

Wall-clock wins require wide levels (the critical path is inherently
sequential); eval_auto falls back to the host path for deep narrow
programs.  `eval_device` runs on the card unless the caller names
another device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..engine.torch_engine import checked_device
from ..golden.field import Fr
from ..ops import field as F
from ..params import FR
from .circuit import ONE
from .comp import Code
from .var import Var


@dataclass
class _Step:
    kind: str                      # affine|mul|div|not|or|eq|if
    out: int                       # output slot
    args: Tuple[int, ...] = ()     # operand slots (unary/binary/ternary)
    terms: Tuple[Tuple[int, int], ...] = ()   # affine: (slot, coef) pairs
    level: int = 0


@dataclass
class WitnessProgram:
    n_slots: int
    input_slots: Dict[Var, int]         # circuit inputs (incl. ONE) -> slot
    var_slot: Dict[Var, int]            # every witness var -> slot
    code_vars: List[Var]                # vars assigned by Code (poison-checked)
    levels: List[List[_Step]]           # steps grouped by level, level order
    n_steps: int = 0
    _device_plan: object = None         # device name -> plan, built by _plan


def compile_witness_program(codes: Sequence[Tuple[Var, Code]],
                            input_vars: Sequence[Var]) -> WitnessProgram:
    """Flatten nested Code trees into leveled primitive steps."""
    slot_of: Dict[Var, int] = {}
    slot_level: Dict[int, int] = {}
    steps: List[_Step] = []
    n = 0

    def new_slot(level: int) -> int:
        nonlocal n
        s = n
        n += 1
        slot_level[s] = level
        return s

    for v in input_vars:
        if v not in slot_of:
            slot_of[v] = new_slot(0)
    if ONE not in slot_of:
        slot_of[ONE] = new_slot(0)

    def emit_affine(aff) -> Tuple[int, int]:
        """-> (slot, level) for an affine combination of known vars."""
        terms = []
        lvl = 0
        for var, coef in sorted(aff.m.items()):
            s = slot_of[var]
            terms.append((s, coef.n))
            lvl = max(lvl, slot_level[s])
        if len(terms) == 1 and terms[0][1] == 1:
            return terms[0][0], lvl           # bare var: alias, no step
        if not terms:                         # zero affine: 0 * ONE
            terms = [(slot_of[ONE], 0)]
        lvl += 1
        out = new_slot(lvl)
        steps.append(_Step("affine", out, terms=tuple(terms), level=lvl))
        return out, lvl

    def emit(c: Code) -> Tuple[int, int]:
        t, a = c.tag, c.args
        if t == "affine":
            return emit_affine(a[0])
        subs = [emit(x) for x in a]
        lvl = 1 + max(l for _, l in subs)
        out = new_slot(lvl)
        steps.append(_Step(t, out, args=tuple(s for s, _ in subs), level=lvl))
        return out, lvl

    code_vars = []
    for v, c in codes:
        s, _ = emit(c)
        if v in slot_of:
            raise AssertionError(f"duplicate witness assignment {v}")
        slot_of[v] = s
        code_vars.append(v)

    max_level = max((st.level for st in steps), default=0)
    levels: List[List[_Step]] = [[] for _ in range(max_level + 1)]
    for st in steps:
        levels[st.level].append(st)
    levels = [lv for lv in levels if lv]

    return WitnessProgram(
        n_slots=n,
        input_slots={v: slot_of[v]
                     for v in list(dict.fromkeys(input_vars)) + [ONE]},
        var_slot=dict(slot_of),
        code_vars=code_vars,
        levels=levels,
        n_steps=len(steps),
    )


def _bind_inputs(prog: WitnessProgram, env: Dict[Var, Fr]) -> Dict[int, Fr]:
    init = {}
    for v, s in prog.input_slots.items():
        if v in env:
            init[s] = env[v]
        elif v == ONE:
            init[s] = Fr(1)
        else:
            raise KeyError(f"witness input not bound: {v}")
    return init


def _finish(prog: WitnessProgram, env: Dict[Var, Fr],
            value_of, poisoned) -> Dict[Var, Fr]:
    """Assemble the result env (mirrors code_eval_list: inputs as given plus
    one binding per Code assignment), raising on a poisoned assignment."""
    out = dict(env)
    for v in prog.code_vars:
        s = prog.var_slot[v]
        if poisoned(s):
            raise ZeroDivisionError("witness division by zero")
        out[v] = value_of(s)
    return out


# ---------------------------------------------------------------------------
# Host evaluator — the oracle and the deep-narrow fallback
# ---------------------------------------------------------------------------

def eval_host(prog: WitnessProgram, env: Dict[Var, Fr]) -> Dict[Var, Fr]:
    vals: List[Optional[Fr]] = [None] * prog.n_slots
    poison = [False] * prog.n_slots
    for s, f in _bind_inputs(prog, env).items():
        vals[s] = f
    one, zero = Fr(1), Fr(0)
    for level in prog.levels:
        for st in level:
            if st.kind == "affine":
                acc, p = zero, False
                for s, coef in st.terms:
                    acc = acc + vals[s] * Fr(coef)
                    p = p or poison[s]
            elif st.kind == "mul":
                a, b = st.args
                acc, p = vals[a] * vals[b], poison[a] or poison[b]
            elif st.kind == "div":
                a, b = st.args
                if vals[b].is_zero():
                    acc, p = zero, True
                else:
                    acc, p = vals[a] / vals[b], poison[a] or poison[b]
            elif st.kind == "not":
                (a,) = st.args
                acc, p = (one if vals[a].is_zero() else zero), poison[a]
            elif st.kind == "or":
                a, b = st.args
                acc = zero if (vals[a].is_zero() and vals[b].is_zero()) else one
                p = poison[a] or poison[b]
            elif st.kind == "eq":
                a, b = st.args
                acc = one if vals[a] == vals[b] else zero
                p = poison[a] or poison[b]
            elif st.kind == "if":
                c, x, y = st.args
                taken = y if vals[c].is_zero() else x
                acc, p = vals[taken], poison[c] or poison[taken]
            else:
                raise ValueError(st.kind)
            vals[st.out], poison[st.out] = acc, p
    return _finish(prog, env, lambda s: vals[s], lambda s: poison[s])


# ---------------------------------------------------------------------------
# Device evaluator: per-level batched Montgomery limb operations
# ---------------------------------------------------------------------------

MAX_DEVICE_LEVELS = 512     # deeper -> per-level dispatch dominates
MIN_AVG_WIDTH = 4.0         # narrower -> no batching to win


def eval_auto(prog: WitnessProgram, env: Dict[Var, Fr],
              device=None) -> Dict[Var, Fr]:
    width = prog.n_steps / max(1, len(prog.levels))
    if len(prog.levels) > MAX_DEVICE_LEVELS or width < MIN_AVG_WIDTH:
        return eval_host(prog, env)
    return eval_device(prog, env, device)


@dataclass
class _LevelOps:
    """Static gather/scatter indices for one level, one op kind.  Batches
    are padded to powers of two (scratch output slot, slot-0 operands), as
    the JAX package pads them for its jitted kernels."""
    kind: str
    outs: torch.Tensor              # (W,) int64 output slots
    srcs: torch.Tensor              # (W, A) int64 operand slots (affine K)
    coefs: Optional[torch.Tensor]   # affine only: (8, W, K) int32 Montgomery


def _pad_w(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())


def _host_plan(prog: WitnessProgram) -> List[List[_LevelOps]]:
    scratch = prog.n_slots  # extra slot appended by eval_device
    plan = []
    for level in prog.levels:
        by_kind: Dict[str, List[_Step]] = {}
        for st in level:
            by_kind.setdefault(st.kind, []).append(st)
        ops = []
        for kind, sts in sorted(by_kind.items()):
            W = _pad_w(len(sts))
            outs = torch.full((W,), scratch, dtype=torch.int64)
            outs[:len(sts)] = torch.tensor([st.out for st in sts])
            if kind == "affine":
                K = max(len(st.terms) for st in sts)
                srcs = torch.zeros((W, K), dtype=torch.int64)
                cints = [0] * (W * K)
                for i, st in enumerate(sts):
                    for k, (s, cn) in enumerate(st.terms):
                        srcs[i, k] = s
                        cints[i * K + k] = cn
                coefs = F.pack_mont(cints, FR).reshape(FR.nl, W, K)
                ops.append(_LevelOps("affine", outs, srcs, coefs))
            else:
                A = len(sts[0].args)
                srcs = torch.zeros((W, A), dtype=torch.int64)
                srcs[:len(sts)] = torch.tensor([st.args for st in sts])
                ops.append(_LevelOps(kind, outs, srcs, None))
        plan.append(ops)
    return plan


def _plan(prog: WitnessProgram, device=None) -> List[List[_LevelOps]]:
    """The levels' gathers, scatters and affine coefficients: built on the
    host once per program and copied once per device, both cached on the
    program."""
    dev = torch.device("cpu" if device is None else device)
    if prog._device_plan is None:
        prog._device_plan = {"cpu": _host_plan(prog)}
    plans = prog._device_plan
    if str(dev) not in plans:
        plans[str(dev)] = [
            [_LevelOps(op.kind, op.outs.to(dev), op.srcs.to(dev),
                       None if op.coefs is None else op.coefs.to(dev))
             for op in ops] for ops in plans["cpu"]]
    return plans[str(dev)]


def _level(vals: torch.Tensor, pois: torch.Tensor, op: _LevelOps,
           one: torch.Tensor, zero: torch.Tensor):
    """One level's batch of one kind -> ((8, W) values, (W,) poison):
    gathers of the operand columns, then the field operations.  `one` and
    `zero` are (8, 1) Montgomery columns on the table's device."""
    s = op.srcs
    if op.kind == "affine":
        W, K = s.shape
        # all W*K products in one multiply, summed in term order
        prod = F.mont_mul(vals[:, s.reshape(-1)],
                          op.coefs.reshape(FR.nl, W * K), FR)
        prod = prod.reshape(FR.nl, W, K)
        acc = prod[:, :, 0]
        for k in range(1, K):
            acc = F.add(acc, prod[:, :, k], FR)
        return acc, pois[s].any(dim=1)
    if op.kind == "not":
        a = s[:, 0]
        return F.select(F.is_zero(vals[:, a]), one, zero), pois[a]
    if op.kind == "if":
        c, x, y = s[:, 0], s[:, 1], s[:, 2]
        cz = F.is_zero(vals[:, c])
        v = F.select(cz, vals[:, y], vals[:, x])
        return v, pois[c] | (cz & pois[y]) | (~cz & pois[x])
    a, b = s[:, 0], s[:, 1]
    va, vb = vals[:, a], vals[:, b]
    p = pois[a] | pois[b]
    if op.kind == "mul":
        return F.mont_mul(va, vb, FR), p
    if op.kind == "div":
        # the Fermat inverse on Montgomery forms: inv(x R) = x^-1 R; zero
        # stays zero, and its lane is poisoned
        den0 = F.is_zero(vb)
        return F.mont_mul(va, F.inv(vb, FR), FR), p | den0
    if op.kind == "or":
        both0 = F.is_zero(va) & F.is_zero(vb)
        return F.select(both0, zero, one), p
    if op.kind == "eq":
        return F.select(F.eq(va, vb), one, zero), p
    raise ValueError(op.kind)


def _device_inputs(prog: WitnessProgram, env: Dict[Var, Fr], device):
    """The value table (8, n_slots + 1) with the bound inputs packed in
    Montgomery form, and a clear poison vector, on `device`.  The trailing
    scratch slot absorbs the padded lanes' outputs (`_plan`)."""
    init = _bind_inputs(prog, env)
    slots = sorted(init)
    vals = torch.zeros((FR.nl, prog.n_slots + 1), dtype=torch.int32)
    vals[:, slots] = F.pack_mont([init[s].n for s in slots], FR)
    pois = torch.zeros(prog.n_slots + 1, dtype=torch.bool)
    return vals.to(device), pois.to(device)


def _run_levels(prog: WitnessProgram, vals: torch.Tensor,
                pois: torch.Tensor) -> None:
    """Every level in order, in place on the table: per kind one `_level`,
    then one scatter into the values and the poison.  The plan and the
    constants reach the device before the loop, so that the loop never
    waits for the device."""
    plan = _plan(prog, vals.device)
    one = F.ones_mont(1, FR, vals.device)
    zero = torch.zeros_like(one)
    for ops in plan:
        for op in ops:
            res, p = _level(vals, pois, op, one, zero)
            vals[:, op.outs] = res
            pois[op.outs] = p


def _device_finish(prog: WitnessProgram, env: Dict[Var, Fr],
                   vals: torch.Tensor, pois: torch.Tensor) -> Dict[Var, Fr]:
    """The table and the poison back to the host once, then `_finish`."""
    host = F.unpack_mont(vals, FR)
    poisoned = pois.cpu().tolist()
    return _finish(prog, env, lambda s: Fr(host[s]), lambda s: poisoned[s])


def eval_device(prog: WitnessProgram, env: Dict[Var, Fr],
                device=None) -> Dict[Var, Fr]:
    """The leveled program on limb tensors: on the card unless `device`
    names another (the CPU takes K1's plain version)."""
    dev = checked_device(device)
    vals, pois = _device_inputs(prog, env, dev)
    _run_levels(prog, vals, pois)
    return _device_finish(prog, env, vals, pois)
