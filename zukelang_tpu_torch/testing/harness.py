"""End-to-end test harness: compile -> QAP -> keygen -> eval -> witness ->
prove -> verify.

Mirrors `Test.Make(F)(Protocol).random_test` (src/lib/test/test.ml:107-179):
random typed inputs, division-by-zero retry on witness generation, the
Lang-interpreter-vs-compiled-Code cross-check (test.ml:158-166), and real
prove/verify on BLS12-381.  The port's own copy of
`zukelang_tpu/testing/harness.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core import comp, lang as L, qap as qap_mod
from ..core.var import Var
from ..golden.field import Fr
from ..rng import Gen


@dataclass
class PipelineResult:
    compiled: comp.Compiled
    qap: qap_mod.QAP
    sol: Dict[Var, Fr]
    public: Dict[Var, Fr]
    output: L.Value
    proof: object
    verified: bool
    pkey: object = None
    vkey: object = None


def _eval_with_retry(compiled, e, rng, inputs_values=None, max_retries=50):
    """test.ml:125-151: resample on division-by-zero during witness gen."""
    for _ in range(max_retries):
        if inputs_values is None:
            _inputs, env_lang, env_code = comp.gen_inputs(compiled.inputs, rng)
        else:
            env_lang = inputs_values
            _inputs, env_code = comp.convert_inputs(compiled.inputs, inputs_values)
        # Some input variables may be dropped from the final circuit
        # (test.ml:134-138).
        gvars = compiled.circuit.vars()
        env_code = {v: f for v, f in env_code.items() if v in gvars}
        try:
            o = L.eval_expr(env_lang, e)
            sol = comp.code_eval_list(env_code, compiled.codes)
            return o, sol
        except ZeroDivisionError:
            if inputs_values is not None:
                raise
            continue
    raise RuntimeError("witness generation kept hitting division by zero")


def run_pipeline(e: L.Expr, protocol, *, seed=0, domain: str = "reference",
                 inputs_values: Optional[dict] = None,
                 keygen_rng=None, prove_rng=None) -> PipelineResult:
    compiled = comp.compile_expr(e)
    q = qap_mod.build(compiled.gates, domain=domain)

    rng = Gen(seed)
    pk, vk = protocol.keygen(keygen_rng or Gen((seed, 1).__repr__().encode()),
                             compiled.circuit, q)

    o, sol = _eval_with_retry(compiled, e, rng, inputs_values)

    # Lang-vs-Code differential check (test.ml:158-166)
    fs_o = L.compile_value(e.ty, o)
    fs_sol = [a.eval(sol, Fr) for a in compiled.result]
    if fs_o != fs_sol:
        raise AssertionError(
            f"evaluator mismatch: lang={fs_o} code={fs_sol} for {e!r}")

    proof = protocol.prove(prove_rng or Gen((seed, 2).__repr__().encode()),
                           q, pk, sol)
    public = {v: f for v, f in sol.items() if v not in compiled.circuit.mids}
    verified = protocol.verify(public, vk, proof)
    return PipelineResult(compiled=compiled, qap=q, sol=sol, public=public,
                          output=o, proof=proof, verified=verified,
                          pkey=pk, vkey=vk)


def random_test(e: L.Expr, protocol, *, seed=0, domain: str = "reference"):
    res = run_pipeline(e, protocol, seed=seed, domain=domain)
    assert res.verified, f"proof failed to verify for {e!r}"
    return res
