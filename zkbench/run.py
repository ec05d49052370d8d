"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m zkbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, the benchmark
(`zkbench/`) and the program (`zukelang_tpu_torch/`).  Exits non-zero,
printing no result, without enough CUDA devices for the cell, when the
program cannot be loaded, or when JAX or the JAX package was loaded.
With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics and the breakdown of the traced proves.
"""

import time

T_PROCESS = time.perf_counter()

import argparse    # noqa: E402
import json        # noqa: E402
import sys         # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zukelang_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness
    bench = harness.load_benchmark()
    cell, _config, _traffic = harness.cell_parts(bench, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zkbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_PROCESS)
    rec = out["record"]
    bad = forbidden_modules()
    if bad:
        print(f"zkbench: loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if args.trace and rec.get("trace"):
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    result = {"correct": out["correct"], "attempted": rec["attempted"],
              "failed": rec["checks"]["failed"], "metrics": out["metrics"],
              "device": device}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in out["checks"].items()}
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
