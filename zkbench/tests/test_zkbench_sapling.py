"""The Sapling-shaped cell (`groth16-sapling-spend`) on the CPU: the
generator's circuit is satisfied by every witness of its pool, at full
size and at a small composition; its BLAKE2s blocks are BLAKE2s; the
reference's scalars are a direct sum over the rows; a run of the cell's
protocol at a small size, with the program's plain kernel versions, is
correct; the control's faults (a 128-bit cut and a flipped bit column)
each come out not correct; `reduction_roofline` reads its record."""

import hashlib
import json
import os
import random
import subprocess
import sys

import pytest

from conftest import ROOT

from zkbench import (circuits_sapling as S, control_groth16_r1cs as control,
                     costs_reduction, harness)
from zkbench.protocols import groth16_r1cs as proto
from zkbench.reference import groth16_r1cs as ref_mod

R = ref_mod.R
CELL = "groth16-sapling-spend-rand"
TRAFFIC = {"witnesses": 4}
SMALL = {"blake2s_blocks": 0, "digest_bits": 6, "merkle_levels": 0,
         "note_commitment": False, "value_bits": 3, "scalar_bits": 6,
         "ivk_bits": 3, "node_bits": 255}


def _config(**change):
    with open(os.path.join(ROOT, "zkbench/configs/groth16-sapling-spend.json")
              ) as f:
        conf = json.load(f)
    conf.update(change)
    return conf


def small_bench(root, gates=160, logn=8, composition=SMALL):
    """BENCHMARK.json's entries with one more cell, `small`, of the
    groth16-sapling-spend configuration at a small composition, `gates`
    rows in a 2^logn domain, its configuration file written under
    `root`."""
    bench = harness.load_benchmark(ROOT)
    conf = _config(name="small", gates=gates, domain_log=logn,
                   composition=dict(composition))
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", "small.json"), "w") as f:
        json.dump(conf, f)
    bench["configs"].append({"name": "small", "file": "configs/small.json"})
    bench["workloads"].append({"name": "small", "config": "small",
                               "traffic": "rand", "chips": 1})
    return bench, conf


def test_full_circuit_is_satisfied_by_every_witness():
    inst = S.build(_config(), TRAFFIC, 2 ** 31 + 21)
    sh = S.shares(inst)
    assert sh["rows"] == 98777 and inst.logn == 17
    assert list(inst.ios) == list(range(8))
    assert sh["widest"] == 255
    assert sh["bit_mids"] > sh["mids"] // 2
    assert all(S.satisfied(inst, j) for j in range(4))


def test_composition_rows_before_the_fill():
    cs = S.R1CS(1)
    S.spend(cs, _config()["composition"], S._Draw(5, 1))
    assert cs.rows == 93928


@pytest.mark.parametrize("gates", [128, 160, 256])
def test_small_circuit_is_satisfied(gates):
    inst = S.build(_config(gates=gates, domain_log=8, composition=SMALL),
                   TRAFFIC, 9)
    assert len(inst.gates[0][0]) - 1 == gates
    assert all(S.satisfied(inst, j) for j in range(4))
    bad = [list(w) for w in inst.witnesses]
    bad[0][inst.mids[0]] += 1
    inst.witnesses = bad
    assert not S.satisfied(inst, 0)


def test_composition_that_does_not_fit_is_refused():
    with pytest.raises(ValueError, match="more than"):
        S.build(_config(gates=100, domain_log=8, composition=SMALL),
                TRAFFIC, 9)


@pytest.mark.parametrize("personal", S.BLAKE2S_PERSONAL)
def test_blake2s_block_is_blake2s(personal):
    cs = S.R1CS(3)
    rng = random.Random(personal)
    msg = [[rng.getrandbits(32) for _ in range(3)] for _ in range(16)]
    bits = S.blake2s(cs, msg, personal)
    assert cs.rows == 21792
    for j in range(3):
        data = b"".join(m[j].to_bytes(4, "little") for m in msg)
        want = hashlib.blake2s(data, digest_size=32, person=personal).digest()
        got = sum(S.bit_vals(cs, b)[j] << i for i, b in enumerate(bits))
        assert got.to_bytes(32, "little") == want


def test_reference_scalars_are_sums_over_the_rows():
    """A(tau), B(tau), C(tau) and the C-mid scalar against a sum per
    column (each column's coefficients times L_g(tau), then times its
    value), the transpose of the reference's row sums."""
    conf = _config(gates=160, domain_log=8, composition=SMALL)
    inst = S.build(conf, TRAFFIC, 13)
    ref = ref_mod.for_instance(conf, inst)
    for widx in range(4):
        w, got = inst.witnesses[widx], ref.scalars(widx)
        per = []
        for off, cols, coefs in inst.gates:
            col_sum = [0] * inst.n_vars
            for g in range(len(off) - 1):
                for t in range(off[g], off[g + 1]):
                    col_sum[cols[t]] += ref.lag[g] * coefs[t]
            per.append([c % R for c in col_sum])
        full = [sum(c * v for c, v in zip(p, w)) % R for p in per]
        mid = [sum(p[c] * w[c] for c in inst.mids) % R for p in per]
        assert [got["A"], got["B"], got["C"]] == full
        assert got["Cmid"] == (ref.beta * mid[0] + ref.alpha * mid[1]
                               + mid[2]) * ref.dinv % R


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    from zukelang_tpu_torch.protocols import groth16_device as gd
    import torch
    torch.set_num_threads(1)
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        _bench, conf = small_bench(str(tmp_path_factory.mktemp("small")))
        yield proto.Cell(conf, TRAFFIC, 2 ** 31 + 5, "cpu")
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved


def test_small_run_is_correct(cell):
    from zkbench.protocols import groth16 as g16
    win = g16.window(cell, 0.01, timed=False)
    counts = proto.judge(cell.config, cell.inst, win["proofs"])
    chk = harness.checks(cell.config, counts)
    assert all(c["ok"] for c in chk.values()), counts
    assert counts["reduction_checked"] >= 1
    assert cell.fc.nnz == sum(len(c) for _o, c, _k in cell.inst.gates)
    assert len(cell.vkey.ltgm_io) == 8


def test_small_run_with_a_flipped_bit_is_not_correct(cell, monkeypatch):
    """A prover handed a witness with one bit column flipped."""
    import torch
    from zkbench.protocols import groth16 as g16
    from zukelang_tpu_torch.core import flat
    inst = cell.inst
    col = next(c for c in inst.mids.tolist()
               if all(w[c] in (0, 1) for w in inst.witnesses))
    flipped = []
    for w in inst.witnesses:
        w = list(w)
        w[col] ^= 1
        flipped.append(flat.pack_witness_values(w))
    monkeypatch.setattr(cell, "pool", flipped)
    win = g16.window(cell, 0.01, timed=False)
    counts = proto.judge(cell.config, inst, win["proofs"])
    assert counts["proof_mismatch"] >= 1 and counts["msm_mismatch"] >= 1
    assert isinstance(flipped[0], torch.Tensor)


@pytest.mark.parametrize("fault", control.FAULTS)
def test_control_is_not_correct(tmp_path, monkeypatch, fault):
    bench, _ = small_bench(str(tmp_path))
    for seed in (1, 2):
        res = control.run_control(bench, "small", seed, 6, fault,
                                  root=str(tmp_path))
        assert not res["correct"], res
    if fault == "cut":
        # the same machinery at full width is correct: the cut is what fails
        monkeypatch.setattr(control, "WIDTH", 255)
        full = control.run_control(bench, "small", 1, 6, fault,
                                   root=str(tmp_path))
        assert full["correct"], full


def test_reduction_roofline_reads_its_record():
    from zkbench.metrics import reduction_roofline as m
    shape = {"nnz": 533318, "logn": 17, "vars": 98108}
    least = costs_reduction.least_seconds(shape, 5.45e12)
    # 7 transforms of 2^16 x 17 butterflies, the terms and N quotient
    # products, 128 limb products each: compute-bound
    assert least == pytest.approx(
        (533318 + 7 * 65536 * 17 + 131072) * 128 / 5.45e12)
    rec = {"trace": {"reduction_device_s": 3 * least * 4, "proves": 3},
           "peak_limb_products_per_s": 5.45e12, "reduction_shape": shape}
    assert m.read(rec) == pytest.approx(25.0)
    for key in ("trace", "peak_limb_products_per_s", "reduction_shape"):
        assert m.read({k: v for k, v in rec.items() if k != key}) is None
    assert m.read({**rec, "trace": {"reduction_device_s": None,
                                    "proves": 3}}) is None


def test_benchmark_lists_the_cell():
    bench = harness.load_benchmark(ROOT)
    cell, conf, traffic = harness.cell_parts(bench, CELL, ROOT)
    assert (conf["gates"], conf["domain_log"], conf["public_inputs"],
            conf["reduced"], cell["chips"]) == (98777, 17, 7, [], 1)
    traced = [m["name"] for m in harness.metric_entries(bench, CELL, True)]
    assert "reduction_roofline" in traced and "fold_ms" not in traced
    assert "assemble_ms" in traced


FORBIDDEN = ("jax", "jaxlib", "flax", "zukelang_tpu")

_CPU_RUN = r"""
import json, sys, time
T = time.perf_counter()
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from test_zkbench_sapling import small_bench
from zkbench import harness, trace
from zukelang_tpu_torch.protocols import groth16_device as gd
gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
trace.profile = lambda *a, **k: None     # the profiler needs the card
bench, _ = small_bench({tmp!r})
for m in bench["end_to_end"] + bench["per_layer"]:
    if {cell!r} in m.get("workloads", []):
        m["workloads"].append("small")
out = harness.run_cell(bench, "small", 2 ** 31 + 93, 0.5, {traced}, "cpu",
                       T, root={tmp!r})
mods = sorted({{m.split(".")[0] for m in sys.modules}} & set({forbidden!r}))
print(json.dumps({{"correct": out["correct"], "forbidden": mods,
                  "checks": {{k: c["value"]
                             for k, c in out["checks"].items()}},
                  "metrics": sorted(out["metrics"]),
                  "terms": out["record"]["msm_terms"],
                  "shape": out["record"]["reduction_shape"]}}))
"""


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_cpu_run_is_correct_and_loads_no_jax(tmp_path, traced):
    code = _CPU_RUN.format(root=ROOT, tests=os.path.dirname(__file__),
                           tmp=str(tmp_path), forbidden=FORBIDDEN,
                           traced=traced, cell=CELL)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"], out
    assert out["checks"]["reduction_checked"] >= 1
    assert out["terms"]["g1"][:3] == [256, 256, 255]
    assert out["shape"]["logn"] == 8
    if traced:
        # no profiler trace, no card: the program's spans and the
        # benchmark's own
        assert out["metrics"] == sorted([
            "assemble_ms", "host_ms", "keygen_s", "msm_enqueue_ms",
            "msm_ms", "msm_wait_ms", "pack_s", "reduction_ms",
            "witness_copy_ms"])
    else:
        assert out["metrics"] == ["proofs_per_s", "prove_p90_s", "setup_s"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import zkbench.reference.groth16_r1cs, zkbench.circuits_sapling\n"
            "import zkbench.control_groth16_r1cs, zkbench.costs_reduction\n"
            "print(json.dumps(sorted({m.split('.')[0]\n"
            "                         for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not mods & {"torch", "zukelang_tpu_torch", *FORBIDDEN}


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
    want = {0: {"proofs_per_s", "prove_p90_s", "prove_peak_gib", "setup_s"},
            1: {"keygen_s", "host_ms", "reduction_ms", "msm_ms",
                "msm_roofline", "idle_share", "launches_per_proof",
                "witness_copy_ms", "msm_enqueue_ms", "msm_wait_ms",
                "assemble_ms", "pack_s", "reduction_roofline"}}[trace]
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["metrics"]["reduction_roofline"]["value"] <= 100
