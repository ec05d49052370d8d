"""The Pinocchio cell at a tiny size on the CPU, with the program's plain
kernel versions: a whole run through the harness comes out correct and
loads neither JAX nor the JAX package; faults planted in the timed path
(one MSM result off, dv swapped with dw in the fold, the reduction's h off
in one coefficient) and the control each come out not correct.  On the
card: a short run of the cell through the entry point, traced and not.
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

from zkbench import control_pinocchio as control
from zkbench import harness
from zkbench.protocols import pinocchio as proto

CELL = "pinocchio-zk-2p14-rand"
FORBIDDEN = ("jax", "jaxlib", "flax", "zukelang_tpu")


def tiny_pinocchio(root, gates=12, logn=4):
    """BENCHMARK.json's entries with one more cell, `tiny`, of the
    pinocchio-zk-2p14 configuration cut to `gates` chain gates in a 2^logn
    domain with 2^logn + 2 columns, its configuration file written under
    `root`."""
    bench = harness.load_benchmark(ROOT)
    with open(os.path.join(ROOT, "zkbench/configs/pinocchio-zk-2p14.json")) \
            as f:
        conf = json.load(f)
    conf.update(name="tiny", gates=gates, domain_log=logn,
                vars=(1 << logn) + 2)
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    bench["configs"].append({"name": "tiny", "file": "configs/tiny.json"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "rand", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny")
    return bench, conf


_CPU_RUN = r"""
import json, sys, time
T = time.perf_counter()
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from test_zkbench_pinocchio import tiny_pinocchio
from zkbench import harness, trace
from zukelang_tpu_torch.protocols import groth16_device as gd
gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
trace.profile = lambda *a, **k: None     # the profiler needs the card
bench, _ = tiny_pinocchio({tmp!r})
out = harness.run_cell(bench, "tiny", 2 ** 31 + 91, 0.5, {traced}, "cpu", T,
                       root={tmp!r})
mods = sorted({{m.split(".")[0] for m in sys.modules}} & set({forbidden!r}))
checks = {{k: c["value"] for k, c in out["checks"].items()}}
print(json.dumps({{"correct": out["correct"], "forbidden": mods,
                  "checks": checks,
                  "metrics": sorted(out["metrics"]),
                  "terms": out["record"]["msm_terms"]}}))
"""


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_cpu_run_is_correct_and_loads_no_jax(tmp_path, traced):
    code = _CPU_RUN.format(root=ROOT, tests=os.path.dirname(__file__),
                           tmp=str(tmp_path), forbidden=FORBIDDEN,
                           traced=traced)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"], out
    assert out["checks"]["reduction_checked"] >= 1
    # 12 chain values of 16 mids, 14 of the 18 held columns and the 15
    # coefficients of h not zero
    assert out["terms"] == {"g1": [12, 12, 15, 12, 12, 12, 14, 14],
                            "g2": [12, 12]}
    if traced:
        # no profiler trace, no card: the program's spans and the
        # benchmark's own
        assert out["metrics"] == sorted([
            "fold_ms", "host_ms", "keygen_s", "msm_enqueue_ms", "msm_ms",
            "msm_wait_ms", "pack_s", "reduction_ms", "witness_copy_ms"])
    else:
        assert out["metrics"] == ["proofs_per_s", "prove_p90_s", "setup_s"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import zkbench.reference.pinocchio\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not mods & {"torch", "zukelang_tpu_torch", *FORBIDDEN}


# -- faults planted in the timed path, judged as a run is ------------------

@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    from zukelang_tpu_torch.protocols import groth16_device as gd
    import torch
    torch.set_num_threads(1)
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        _bench, conf = tiny_pinocchio(str(tmp_path_factory.mktemp("tiny")))
        with open(os.path.join(ROOT, "zkbench/traffic/rand.json")) as f:
            traffic = json.load(f)
        yield proto.Cell(conf, traffic, 2 ** 31 + 13, "cpu")
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved


def _judged(cell):
    from zkbench.protocols.groth16 import window
    win = window(cell, 0.01, timed=False)
    counts = proto.judge(cell.config, cell.inst, cell.coefs, cell.held,
                         win["proofs"])
    chk = harness.checks(cell.config, counts)
    return all(c["ok"] for c in chk.values()), counts


def test_sound_window_is_correct(cell):
    ok, counts = _judged(cell)
    assert ok, counts


def test_one_msm_result_off(cell, monkeypatch):
    from zukelang_tpu_torch.golden.curve import G1
    from zukelang_tpu_torch.ops import curve as C
    orig = C.unpack_g1

    def off(p):
        out = orig(p)
        return [out[0] + G1.generator()] + out[1:]
    monkeypatch.setattr(C, "unpack_g1", off)
    ok, counts = _judged(cell)
    assert not ok and counts["msm_mismatch"] >= 1
    assert counts["proof_mismatch"] >= 1


def test_dv_swapped_with_dw_in_the_fold(cell, monkeypatch):
    from zukelang_tpu_torch.protocols import pinocchio_device as pd
    orig = pd.zk_fold

    def swapped(pkey, sums, v_all, w_all, tail, dv, dw, dy):
        return orig(pkey, sums, v_all, w_all, tail, dw, dv, dy)
    monkeypatch.setattr(pd, "zk_fold", swapped)
    ok, counts = _judged(cell)
    assert not ok and counts["proof_mismatch"] == counts["proofs"]
    assert counts["msm_mismatch"] == 0


def test_reduction_h_off_in_one_coefficient(cell, monkeypatch):
    from zukelang_tpu_torch.engine import torch_engine as te
    orig = te.run_witness_reduction

    def altered(*a, **k):
        a_, b_, h = orig(*a, **k)
        h = h.clone()
        h[0, 1] ^= 1
        return a_, b_, h
    monkeypatch.setattr(te, "run_witness_reduction", altered)
    ok, counts = _judged(cell)
    assert not ok and counts["reduction_mismatch"] >= 1
    assert counts["msm_mismatch"] >= 1


def test_control_is_not_correct(tmp_path, monkeypatch):
    bench, _ = tiny_pinocchio(str(tmp_path), gates=200, logn=8)
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


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, trace):
    res = subprocess.run(
        [sys.executable, "-m", "zkbench.run", "--workload", CELL, "--seed",
         str(2 ** 31 + 7), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    want = {0: {"proofs_per_s", "prove_p90_s", "prove_peak_gib", "setup_s"},
            1: {"keygen_s", "host_ms", "reduction_ms", "msm_ms",
                "msm_roofline", "idle_share", "launches_per_proof",
                "witness_copy_ms", "msm_enqueue_ms", "msm_wait_ms",
                "pack_s", "fold_ms"}}[trace]
    assert set(out["metrics"]) == want
