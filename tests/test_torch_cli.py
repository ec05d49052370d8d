"""The port's CLI (`python -m zukelang_tpu_torch`) against the JAX
package's: `compile` prints the same circuit, `prove --device cpu
--domain ntt` writes the same proof document for the same program and
seed, each package's `verify` accepts the other's document, a tampered
document exits 1, and without CUDA the default device refuses to prove.
Windows pinned small (MSM c = 4, fixed base c = 4).  Tolerance: exact
(the JSON documents)."""

import json

import pytest
import torch

from zukelang_tpu.__main__ import main as jmain
from zukelang_tpu_torch.__main__ import main

from test_frontend import PROGRAMS, src
from test_torch_core import same_counters, small_windows  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def program(tmp_path):
    path = tmp_path / "prog.py"
    path.write_text(src(PROGRAMS["cubic"]))
    return str(path)


def _run(fn, argv):
    with same_counters():
        fn(argv)


def test_compile_prints_the_jax_circuit(program, capsys):
    _run(jmain, ["compile", program])
    want = capsys.readouterr().out
    _run(main, ["compile", program])
    assert capsys.readouterr().out == want


def test_prove_document_equals_jax_and_verifies_both_ways(
        program, tmp_path, small_windows, capsys):
    port_doc, jax_doc = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    args = ["prove", program, "--domain", "ntt", "--seed", "3",
            "--input", "input=5"]
    _run(jmain, args + ["--proof", jax_doc])
    _run(main, args + ["--proof", port_doc, "--device", "cpu"])
    with open(port_doc) as f, open(jax_doc) as g:
        doc = json.load(f)
        assert doc == json.load(g)
    capsys.readouterr()
    _run(main, ["verify", jax_doc])
    _run(jmain, ["verify", port_doc])
    assert capsys.readouterr().out.count("verified=True") == 2

    doc["proof"]["a"] = doc["vkey"]["one1"]
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(doc, f)
    with pytest.raises(SystemExit) as e:
        _run(main, ["verify", bad])
    assert e.value.code == 1


def test_default_device_refuses_to_prove_without_cuda(program, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "p.json")
    for argv in (["prove", program, "--proof", out],
                 ["test", "--protocol", "pinocchio"],
                 ["bench", "--log-constraints", "4"]):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            _run(main, argv)
