"""The port's bench entry point on the CPU: `bench_lib.run_groth16` /
`bench_groth16` at 2^6 (windows 4, no canonical padding), its keypair
checkpoint resume, the rung record of `bench_rung` (its modeled
`vs_baseline` and its error record), and the bench's plan and headline
against the JAX package's root `bench.py`.

Tolerance: exact (proof bytes, record keys, counts, the cost model's
floats computed by the same expression)."""

import importlib.util
import os

import pytest
import torch

from zukelang_tpu import bench_lib as jbench
from zukelang_tpu import bench_rung as jrung
from zukelang_tpu_torch import bench, bench_lib, bench_rung
from zukelang_tpu_torch.protocols import groth16_device as gd

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {"build_r1cs_s", "keygen_s", "prove_first_s", "prove_s", "verify_s"}


def _small(mp):
    """Windows 4 and no canonical padding, as the JAX bench's CPU tests."""
    mp.setattr(gd, "DEFAULT_MSM_WINDOW", 4)
    mp.setattr(gd, "DEFAULT_FB_WINDOW", 4)
    mp.setenv("BENCH_CANON_LOG", "0")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two runs at 2^6 with a checkpoint path: the first keygens and
    writes the keypair, the second loads it."""
    ckpt = str(tmp_path_factory.mktemp("bench") / "crs")
    with pytest.MonkeyPatch.context() as mp:
        _small(mp)
        mp.setenv("ZUKELANG_CRS_CHECKPOINT", ckpt)
        progress = ({}, {})
        first = bench_lib.run_groth16(6, repeats=1, device="cpu",
                                      progress=progress[0])
        second = bench_lib.run_groth16(6, repeats=1, device="cpu",
                                       progress=progress[1])
    return first, second, progress, ckpt


def test_run_groth16_verifies_with_the_jax_counts(runs):
    first = runs[0]
    rec = first.record()
    j = jbench.make_synthetic_r1cs(6, seed=1)
    n = 1 << 6
    assert first.verified and rec["verified"]
    assert rec["domain_log"] == j.fc.logn == 6
    assert rec["msm_terms_per_prove"] == 4 * n + len(j.mids_cols) + 3 * n
    assert rec["prove_s"] == min(first.warm_s)
    assert rec["msm_mops_per_s"] == (rec["msm_terms_per_prove"]
                                     / rec["prove_s"] / 1e6)
    # no card: no launches, no device peak
    assert first.keygen_peak_mb is None and first.prove_peak_mb is None
    assert not any(first.prove_launches.values())


def test_progress_is_kept_stage_by_stage(runs):
    first, second, progress, _ckpt = runs
    assert set(progress[0]) == STAGES
    assert set(progress[1]) == STAGES | {"resumed_from_checkpoint"}
    assert progress[1]["resumed_from_checkpoint"] is True
    assert progress[0]["keygen_s"] == round(first.keygen_s, 3)
    assert progress[0]["prove_s"] == round(min(first.warm_s), 4)


def test_checkpoint_resume_proves_the_same(runs):
    first, second, _progress, ckpt = runs
    assert os.path.exists(ckpt + ".npz")
    assert not first.resumed_from_checkpoint
    assert second.resumed_from_checkpoint and second.verified
    # the same keypair and the same prove seed: the same proof
    for part in ("a", "b", "c"):
        assert (getattr(second.proof, part).to_compressed_bytes()
                == getattr(first.proof, part).to_compressed_bytes())


@pytest.mark.parametrize("n,terms", [(1 << 6, 512), (1 << 14, 8 * (1 << 14)),
                                     (1 << 16, 7 * (1 << 16) + 65536),
                                     (1 << 20, 7 * (1 << 20) + (1 << 20))])
def test_ref_cost_equals_the_jax_model(n, terms):
    assert bench_rung._ref_cost_s(n, terms) == jrung._ref_cost_s(n, terms)


def test_run_rung_error_record_after_a_keygen_failure(monkeypatch):
    _small(monkeypatch)

    def broken(*a, **k):
        raise RuntimeError("planted keygen failure " + "x" * 400)
    monkeypatch.setattr(gd, "keygen_device", broken)
    progress = {}
    rec = bench_rung.run_rung("groth16", 6, 1, progress, device="cpu")
    assert rec["value"] == -1 and rec["vs_baseline"] == 0
    assert rec["metric"] == "groth16_prove_2^6" and rec["unit"] == "s"
    assert rec["error"].startswith("RuntimeError: planted keygen failure")
    assert len(rec["error"]) == 300
    assert rec["detail"]["stage_reached"] == "build_r1cs_s"
    assert set(rec["detail"]["stage_timings"]) == {"build_r1cs_s"}


def test_flushing_progress_writes_each_stage(tmp_path):
    import json
    path = str(tmp_path / "rung.json")
    prog = bench_rung._FlushingProgress(path)
    prog["build_r1cs_s"] = 0.5
    prog["keygen_s"] = 2.0
    with open(path) as f:
        assert json.load(f) == {"done": False, "progress": {
            "build_r1cs_s": 0.5, "keygen_s": 2.0}}
    assert bench_rung._stage_reached(prog) == "keygen_s"
    assert bench_rung._stage_reached({}) == "start"


def _root_bench():
    """The JAX package's bench, root bench.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rungs", ["g16:16,pin:14,g16:20",
                                   "groth16:12, pin:14,g16:16",
                                   "pin:14"])
def test_plan_parses_bench_rungs_as_the_jax_bench(monkeypatch, rungs):
    monkeypatch.setenv("BENCH_RUNGS", rungs)
    assert bench._plan() == _root_bench()._plan()


def test_default_plan_runs_every_rung_of_the_jax_bench(monkeypatch):
    monkeypatch.delenv("BENCH_RUNGS", raising=False)
    monkeypatch.delenv("BENCH_LOG_CONSTRAINTS", raising=False)
    assert bench._plan() == [("groth16", 16), ("pinocchio", 14),
                             ("groth16", 20)]
    monkeypatch.setenv("BENCH_LOG_CONSTRAINTS", "20")
    assert bench._plan() == [("groth16", 20), ("pinocchio", 14)]


def _rec(metric, value):
    return {"metric": metric, "value": value, "unit": "s",
            "vs_baseline": 1.0 if value > 0 else 0,
            "detail": {"verified": value > 0, "keygen_s": 1.5}}


@pytest.mark.parametrize("values", [
    {"groth16:16": 0.1, "pinocchio:14": 0.2, "groth16:20": 1.1},
    {"groth16:16": 0.1, "pinocchio:14": 0.2, "groth16:20": -1},
    {"groth16:16": -1, "pinocchio:14": 0.2, "groth16:20": -1},
    {"groth16:16": -1, "pinocchio:14": -1, "groth16:20": -1},
    {"groth16:12": 0.05, "pinocchio:14": 0.2, "groth16:16": 0.1}])
def test_headline_picks_as_the_jax_bench(monkeypatch, capsys, values):
    import json
    monkeypatch.setenv("BENCH_RUNGS", ",".join(values))
    monkeypatch.delenv("BENCH_LOG_CONSTRAINTS", raising=False)
    results = {}

    def fake(proto, log_n, repeats, timeout_s):
        rec = _rec(f"{proto}_prove_2^{log_n}", values[f"{proto}:{log_n}"])
        results[(proto, log_n)] = rec
        return dict(rec, detail=dict(rec["detail"]))
    root = _root_bench()
    monkeypatch.setattr(root, "_run_rung_subprocess", fake)
    root.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench._headline([results[r] for r in bench._plan()], 16, 0.0)
    assert got["metric"] == want["metric"] and got["value"] == want["value"]
    assert got["detail"]["rungs"] == want["detail"]["rungs"]
