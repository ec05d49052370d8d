"""The benchmark's data-driven core: cells, configurations, traffic mixes
and metrics are found by the names in `BENCHMARK.json`.

  configuration   the `file` of its entry in `configs` (JSON)
  traffic mix     zkbench/traffic/<traffic>.json
  protocol        zkbench/protocols/<config's "protocol">.py: `run()`
                  returns the run's record, `LIMITS` (in its reference)
                  the limits of the numbers its judge compares
  metric          zkbench/metrics/<name>.py: `read(record)` -> a number,
                  or None where the record holds nothing to read

A run's record: setup_s, keygen_s, window_s, latencies_s,
window_peak_bytes, memory_peak_bytes, msm_terms, attempted, checks; with
tracing also spans (prove_s, reduction_s, msm_s a prove), trace
(`zkbench.trace.summarise`, or None) and, on a card,
peak_limb_products_per_s (`zkbench.peak`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str = ".") -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str, root: str = "."):
    """(cell, configuration, traffic mix) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic


def metric_entries(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's metrics: end-to-end untraced, per-layer traced."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def _reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "zkbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], rec: dict) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = _reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def protocol(config: dict):
    return importlib.import_module("zkbench.protocols." + config["protocol"])


def limits(config: dict) -> dict:
    return importlib.import_module(
        "zkbench.reference." + config["protocol"]).LIMITS


def checks(config: dict, counts: dict) -> Dict[str, dict]:
    """Each compared number beside its limit, and whether it holds."""
    out = {}
    for name, (op, limit) in limits(config).items():
        v = counts.get(name)
        ok = v is not None and (v <= limit if op == "<=" else v >= limit)
        out[name] = {"value": v, "limit": f"{op} {limit}", "ok": ok}
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_process: float, root: str = ".") -> dict:
    """One run of a cell -> {record, checks, correct, metrics, breakdown}."""
    cell, config, traffic = cell_parts(bench, workload, root)
    rec = protocol(config).run(config, traffic, seed, seconds, traced,
                               device, t_process)
    chk = checks(config, rec["checks"])
    out = {"record": rec, "checks": chk,
           "correct": all(c["ok"] for c in chk.values()),
           "metrics": read_metrics(metric_entries(bench, workload, traced),
                                   rec),
           "breakdown": None}
    tr: Optional[dict] = rec.get("trace")
    if traced and tr:
        out["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                            "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    return out
