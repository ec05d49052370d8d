"""A short run of each cell through the entry point on the card: the
result line has every required key and `correct` is true."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, trace):
    res = subprocess.run(
        [sys.executable, "-m", "zkbench.run", "--workload",
         "groth16-2p16-rand", "--seed", str(2 ** 31 + 3), "--seconds", "3",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900, env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    want = {0: {"proofs_per_s", "prove_p90_s", "prove_peak_gib", "setup_s"},
            1: {"keygen_s", "host_ms", "reduction_ms", "msm_ms",
                "msm_roofline", "idle_share", "launches_per_proof"}}[trace]
    assert set(out["metrics"]) == want


def test_peak_probe(card):
    """The measured rate of limb products is of the card's order: between
    a tenth of and twice 132 SMs x 32 lo/hi pairs a clock at 1.98 GHz."""
    from zkbench import peak
    rate = peak.limb_products_per_s(card)
    assert 0.1 * 8.36e12 < rate < 2 * 8.36e12
