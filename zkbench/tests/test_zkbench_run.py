"""Whole runs on the CPU at a tiny size, with the program's plain kernel
versions: the reference agrees with the program; each fault planted in
the timed path, and the control, come out as not correct; a run loads
neither JAX nor the JAX package; the entry point refuses without a card.
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_bench

from zkbench import control, harness
from zkbench.protocols import groth16 as proto

FORBIDDEN = ("jax", "jaxlib", "flax", "zukelang_tpu")

_CPU_RUN = r"""
import json, sys, time
T = time.perf_counter()
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from conftest import tiny_bench
from zkbench import harness
from zukelang_tpu_torch.protocols import groth16_device as gd
gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
bench, _ = tiny_bench({tmp!r})
out = harness.run_cell(bench, "tiny", 2 ** 31 + 77, 0.5, False, "cpu", T,
                       root={tmp!r})
mods = sorted({{m.split(".")[0] for m in sys.modules}} & set({forbidden!r}))
print(json.dumps({{"correct": out["correct"], "forbidden": mods,
                  "checks": {{k: c["value"] for k, c in out["checks"].items()}},
                  "metrics": sorted(out["metrics"])}}))
"""


def test_cpu_run_is_correct_and_loads_no_jax(tmp_path):
    code = _CPU_RUN.format(root=ROOT, tests=os.path.dirname(__file__),
                           tmp=str(tmp_path), forbidden=FORBIDDEN)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"], out
    assert out["checks"]["reduction_checked"] >= 1
    assert out["metrics"] == ["proofs_per_s", "prove_p90_s", "setup_s"]


def test_entry_point_refuses_without_a_card():
    res = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload",
                          "groth16-2p16-rand", "--seed", "1", "--seconds",
                          "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_entry_point_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and zkbench/ the run fails
    and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "zkbench"), tmp_path / "zkbench")
    res = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload",
                          "groth16-2p16-rand", "--seed", "1", "--seconds",
                          "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_harness_imports_no_jax():
    """Every module of the benchmark imported in a fresh process leaves no
    JAX or JAX package module behind; the reference loads nothing of the
    program."""
    mods = ["zkbench.run", "zkbench.harness", "zkbench.generator",
            "zkbench.costs", "zkbench.peak", "zkbench.trace",
            "zkbench.control",
            "zkbench.protocols.groth16", "zkbench.reference.groth16",
            "zkbench.reference.bls12_381"]
    code = ("import sys, json\n"
            "import zkbench.reference.groth16, zkbench.generator\n"
            "ref_only = sorted({m.split('.')[0] for m in sys.modules})\n"
            + "".join(f"import {m}\n" for m in mods) +
            "from zkbench import harness\n"
            "b = harness.load_benchmark()\n"
            "for m in b['end_to_end'] + b['per_layer']:\n"
            "    harness._reader(m['name'])\n"
            "print(json.dumps({'ref_only': ref_only, 'all': sorted("
            "{m.split('.')[0] for m in sys.modules})}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert not set(out["all"]) & set(FORBIDDEN)
    assert "zukelang_tpu_torch" not in out["ref_only"]
    assert "torch" not in out["ref_only"]


# -- faults planted in the timed path, judged as a run is ------------------

@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    from zukelang_tpu_torch.protocols import groth16_device as gd
    import torch
    torch.set_num_threads(1)
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        bench, conf = tiny_bench(str(tmp_path_factory.mktemp("tiny")))
        traffic = json.load(open(os.path.join(
            ROOT, "zkbench/traffic/rand.json")))
        c = proto.Cell(conf, traffic, 2 ** 31 + 5, "cpu")
        yield c
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved


def _judged(cell):
    win = proto.window(cell, 0.01, timed=False)
    counts = proto.judge(cell.config, cell.inst, win["proofs"])
    chk = harness.checks(cell.config, counts)
    return all(c["ok"] for c in chk.values()), counts


def test_sound_window_is_correct(cell):
    ok, counts = _judged(cell)
    assert ok, counts


def test_answer_altered_where_produced(cell, monkeypatch):
    from zukelang_tpu_torch.golden.curve import G1
    from zukelang_tpu_torch.protocols import groth16_device as gd
    orig = gd.prove_device

    def prove(*a, **k):
        p = orig(*a, **k)
        return type(p)(a=p.a, b=p.b, c=p.c + G1.generator())
    monkeypatch.setattr(gd, "prove_device", prove)
    ok, counts = _judged(cell)
    assert not ok and counts["proof_mismatch"] >= 1


def test_half_the_terms_left_out(cell, monkeypatch):
    from zukelang_tpu_torch.ops import msm as msm_mod
    orig = msm_mod.msm_many_staged_deferred

    def half(tables, scalars, *a, **k):
        cut = []
        for s in scalars:
            s = s.clone()
            s[:, 1::2] = 0            # every other term (the padding too)
            cut.append(s)
        return orig(tables, cut, *a, **k)
    monkeypatch.setattr(msm_mod, "msm_many_staged_deferred", half)
    ok, counts = _judged(cell)
    assert not ok and counts["msm_mismatch"] >= 1


def test_reduction_output_altered(cell, monkeypatch):
    from zukelang_tpu_torch.engine import torch_engine as te
    orig = te.run_witness_reduction

    def altered(*a, **k):
        a_, b_, h = orig(*a, **k)
        h = h.clone()
        h[0, 0] ^= 1
        return a_, b_, h
    monkeypatch.setattr(te, "run_witness_reduction", altered)
    ok, counts = _judged(cell)
    assert not ok and counts["reduction_mismatch"] >= 1


def test_stale_proof_returned(cell, monkeypatch):
    """The prover hands back its previous proof: a step that returns its
    state unchanged."""
    from zukelang_tpu_torch.protocols import groth16_device as gd
    orig = gd.prove_device
    last = []

    def stale(*a, **k):
        p = orig(*a, **k)
        out = last[-1] if last else p
        last.append(p)
        return out
    monkeypatch.setattr(gd, "prove_device", stale)
    cell.prove()
    ok, counts = _judged(cell)
    assert not ok and counts["proof_mismatch"] >= 1


def test_control_is_not_correct(tmp_path, monkeypatch):
    bench, _ = tiny_bench(str(tmp_path), gates=256, logn=8)
    for seed in (1, 2, 3):
        res = control.run_control(bench, "tiny", seed, proofs=6,
                                  root=str(tmp_path))
        assert not res["correct"], res
    # the same machinery at full width is correct: the cut is what fails
    monkeypatch.setattr(control, "WIDTH", 255)
    for seed in (1, 2, 3):
        full = control.run_control(bench, "tiny", seed, proofs=6,
                                   root=str(tmp_path))
        assert full["correct"], full
