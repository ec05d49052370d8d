"""The port's scaling harness (`parallel/scaling.py`) and dry run
(`parallel/dryrun.py`) on gloo worlds of CPU ranks.

`main` at 2^6 MSM terms (c = 4, two windows) and a 2^8 NTT with
`--device cpu --ranks 2` prints the JAX document (also to `--out`), and
the `measure_msm_scaling` / `measure_ntt_scaling` results in it have the
JAX harness's keys, efficiency 1.0 at one rank and the phase breakdown
at the largest world.  `dryrun_multichip(2, device="cpu")` at logn 6 runs its
three stages, each a test here: the sharded Groth16 and Pinocchio ZK
proves equal to `prove_device`'s under the same rng and verified, and the
c = 8 G1 MSM equal to golden `G1.dot`, at 2^8 terms (2^10 on the card,
`chip_smoke.py` phase 11).  Both start in threads when the module
starts.

Tolerance: exact (proof bytes, compressed points); times only >= 0."""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zukelang_tpu_torch.parallel import dryrun, scaling

torch.set_num_threads(1)

PHASES = {"col_ntt_s", "twiddle_s", "all_to_all_s", "row_ntt_s", "total_s"}


MAIN_ARGS = ["--logn", "6", "--window", "4", "--max-windows", "2",
             "--ntt-logn", "8", "--device", "cpu", "--ranks", "2"]


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The dry run and `scaling.main` at the sizes above, each in a thread
    from module start (each spawns its own worlds)."""
    lines = []
    out = tmp_path_factory.mktemp("scaling") / "scaling.json"
    with ThreadPoolExecutor(2) as pool:
        dry = pool.submit(dryrun.dryrun_multichip, 2, "cpu", 6, 8,
                          lines.append)
        main = pool.submit(scaling.main, MAIN_ARGS + ["--out", str(out)])
        yield {"dryrun": dry, "lines": lines, "main": main, "out": out}


def _check_msm(res):
    assert set(res) == {1, 2}
    for row in res.values():
        assert set(row) == {"time_s", "mterms_per_s", "efficiency"}
        assert row["time_s"] > 0 and row["mterms_per_s"] > 0
    assert res[1]["efficiency"] == 1.0


def _check_ntt(res):
    assert set(res) == {1, 2}
    assert set(res[1]) == {"time_s", "melems_per_s", "efficiency"}
    assert res[1]["efficiency"] == 1.0
    assert set(res[2]) == {"time_s", "melems_per_s", "efficiency",
                           "phase_breakdown"}
    assert set(res[2]["phase_breakdown"]) == PHASES
    assert all(v >= 0 for v in res[2]["phase_breakdown"].values())


def test_measure_msm_scaling_keys(runs):
    """`measure_msm_scaling(6, [1, 2], c=4, max_windows=2, device="cpu")`,
    as `main` calls it."""
    _check_msm(runs["main"].result()["msm"]["scaling"])


def test_measure_ntt_scaling_keys(runs):
    """`measure_ntt_scaling(8, [1, 2], device="cpu")`, as `main` calls
    it."""
    _check_ntt(runs["main"].result()["ntt"]["scaling"])


def test_main_writes_the_document(runs):
    res = runs["main"].result()
    doc = json.loads(runs["out"].read_text())
    assert doc == json.loads(json.dumps(res))
    assert set(doc) == {"note", "devices", "msm", "ntt"}
    assert "gloo" in doc["note"] and "[1, 2]" in doc["note"]
    assert doc["msm"]["logn"] == 6 and doc["msm"]["window"] == 4
    assert doc["ntt"]["logn"] == 8


@pytest.mark.parametrize("stage", dryrun.STAGES)
def test_dryrun_stage(runs, stage):
    got, lines = runs["dryrun"].result()[stage], runs["lines"]
    key = "point" if stage == "msm_c8" else "proof"
    assert np.array_equal(got[key], got["reference"])
    if stage != "msm_c8":
        assert bool(got["verified"])
    assert any(line.startswith("dryrun_multichip:") and "2 ranks" in line
               for line in lines)
