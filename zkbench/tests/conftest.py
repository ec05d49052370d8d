"""Shared set-up of the benchmark's own tests (run them from the root of
the repository: `python -m pytest zkbench/tests -q`).

Tests marked `gpu` need a CUDA device and skip without one; they decide
inside a fixture, never while this module is imported."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_bench(root, gates=16, logn=4):
    """BENCHMARK.json's entries with one more cell, `tiny`, of a
    groth16-2p16 configuration cut to `gates` gates in a 2^logn domain,
    its configuration file written under `root`."""
    from zkbench import harness
    bench = harness.load_benchmark(ROOT)
    with open(os.path.join(ROOT, "zkbench/configs/groth16-2p16.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny", gates=gates, domain_log=logn)
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    bench["configs"].append({"name": "tiny", "file": "configs/tiny.json"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "rand", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).append("tiny")
    return bench, conf


@pytest.fixture
def small_windows(monkeypatch):
    """The program's MSM and fixed-base windows at 4 bits: its plain
    versions then build and prove a tiny circuit in seconds on the CPU."""
    import torch
    from zukelang_tpu_torch.protocols import groth16_device as gd
    torch.set_num_threads(1)
    monkeypatch.setattr(gd, "DEFAULT_MSM_WINDOW", 4)
    monkeypatch.setattr(gd, "DEFAULT_FB_WINDOW", 4)
