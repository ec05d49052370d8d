"""Command-line driver: compile, prove, verify, and benchmark.

The port's own copy of `zukelang_tpu/__main__.py`, with its commands and
flags, plus `--device` (default `cuda`): the protocols run over a
`TorchEngine` on that device, and without CUDA every command that
proves exits non-zero unless `--device cpu` is given (the plain versions
of the kernels).  Programs are Python files whose last function
definition is the ZK program (frontend syntax).  The `prove` document has
the JAX package's schema, so either package's `verify` reads the other's.

Examples:
    python -m zukelang_tpu_torch prove prog.py --input input=5 --proof out.json
    python -m zukelang_tpu_torch verify out.json
    python -m zukelang_tpu_torch prove prog.py --device cpu --domain ntt
    python -m zukelang_tpu_torch bench --log-constraints 14
"""

from __future__ import annotations

import argparse
import json
import sys

PROTOCOLS = ["groth16", "pinocchio", "pinocchio_zk"]


def _load_program(path: str):
    from .frontend import compile_python
    with open(path) as f:
        return compile_python(f.read())


def _parse_inputs(pairs):
    from .core import lang as L
    from .golden.field import Fr
    out = {}
    for pair in pairs or []:
        name, _, val = pair.partition("=")
        if val in ("true", "false"):
            out[name] = L.v_bool(val == "true")
        else:
            out[name] = L.v_field(Fr(int(val, 0)))
    return out


def _protocol(name: str, device: str):
    """The protocol over a `TorchEngine` on `device` (raises without
    CUDA unless the device is the CPU)."""
    from .core.protocol import registry
    from .engine.torch_engine import TorchEngine
    return registry()[name](engine=TorchEngine(device=device))


def cmd_compile(args):
    from .core import comp
    e = _load_program(args.program)
    c = comp.compile_expr(e)
    print(f"program: {e!r}")
    print(f"gates: {len(c.gates)}")
    for g in c.gates:
        print(f"  {g!r}")
    print(f"public inputs: {sorted(c.circuit.inputs_public)}")
    print(f"outputs: {sorted(c.circuit.outputs)}")
    print(f"mids: {sorted(c.circuit.mids)}")


def cmd_prove(args):
    from . import serialize as S
    from .testing.harness import run_pipeline

    e = _load_program(args.program)
    proto = _protocol(args.protocol, args.device)
    inputs = _parse_inputs(args.input) or None
    res = run_pipeline(e, proto, seed=args.seed, domain=args.domain,
                       inputs_values=inputs)
    assert res.verified
    doc = {
        "protocol": args.protocol,
        "domain": args.domain,
        "proof": S.PROOF_TO_JSON[args.protocol](res.proof),
        "vkey": S.VKEY_TO_JSON[args.protocol](res.vkey),
        "public": S.var_map_to_json(res.public, S.fr_to_json),
        "output": repr(res.output),
    }
    out = args.proof or "proof.json"
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"proof written to {out} (verified: {res.verified})")


def cmd_verify(args):
    """Standalone verification from a proof document: the vkey, proof and
    public bindings all travel in the JSON written by `prove` (reference
    schema, serialize.py), so no recompilation or trusted setup rerun.
    Verification is host pairings only: no device is needed."""
    from . import serialize as S
    from .core.protocol import registry
    from .engine.base import GoldenEngine

    with open(args.proof) as f:
        doc = json.load(f)
    protocol = doc["protocol"]
    proto = registry()[protocol](engine=GoldenEngine())
    proof = S.PROOF_OF_JSON[protocol](doc["proof"])
    vkey = S.VKEY_OF_JSON[protocol](doc["vkey"])
    public = S.var_map_of_json(doc["public"], S.fr_of_json)
    ok = proto.verify(public, vkey, proof)
    print(f"{args.proof}: protocol={protocol} verified={ok}")
    if not ok:
        sys.exit(1)


def cmd_bench(args):
    from . import bench_lib
    from .engine.torch_engine import checked_device
    checked_device(args.device)
    if args.protocol == "groth16":
        res = bench_lib.bench_groth16(args.log_constraints,
                                      repeats=args.repeats,
                                      device=args.device)
    else:
        res = bench_lib.bench_pinocchio(args.log_constraints,
                                        repeats=args.repeats,
                                        zk=args.protocol == "pinocchio_zk",
                                        device=args.device)
    print(json.dumps(res, indent=1))


def cmd_test(args):
    from .testing.harness import random_test
    from .testing.suites import SUITE
    for name, mk in SUITE:
        random_test(mk(), _protocol(args.protocol, args.device),
                    seed=args.seed)
        print(f"{name}: ok")


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs "
                        "the kernels' plain versions)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zukelang_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compile", help="compile a program and print the circuit")
    p.add_argument("program")
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser("prove", help="prove a program end to end")
    p.add_argument("program")
    p.add_argument("--protocol", default="groth16", choices=PROTOCOLS)
    p.add_argument("--domain", default="reference",
                   choices=["reference", "ntt"])
    p.add_argument("--input", action="append",
                   help="name=value (repeatable); omitted -> random")
    p.add_argument("--proof", help="output path (default proof.json)")
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="verify a proof document")
    p.add_argument("proof", help="proof JSON written by `prove`")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("bench", help="synthetic R1CS prover benchmark")
    p.add_argument("--log-constraints", type=int, default=14)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--protocol", default="groth16", choices=PROTOCOLS)
    _device_arg(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("test", help="run the reference program suite")
    p.add_argument("--protocol", default="groth16", choices=PROTOCOLS)
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    p.set_defaults(fn=cmd_test)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
