"""The port stands alone: neither its package nor chip_smoke.py imports
jax or anything of the JAX package (`zukelang_tpu`); a process with both
blocked runs the frozen x^3 + x + 3 vectors through the port's Groth16
and Pinocchio ZK on the CPU, byte-equal to the golden proofs;
and chip_smoke.py refuses to run (non-zero exit, no result) where there
is no CUDA device instead of falling back to the CPU."""

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "zukelang_tpu_torch")

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["zukelang_tpu"] = None
import torch
torch.set_num_threads(1)
from zukelang_tpu_torch import vectors
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.ops import kernels
from zukelang_tpu_torch.protocols import groth16_device as gd
from zukelang_tpu_torch.protocols import pinocchio_device as pd
from zukelang_tpu_torch.rng import InjectedRng

gd.DEFAULT_MSM_WINDOW = gd.DEFAULT_FB_WINDOW = 4
vec = vectors.load()
fc, wm = vec.fc, flat.pack_witness_values(vec.witness, "cpu")
rng = lambda use: InjectedRng(vec.scalars[use])
crs, gvk = gd.keygen_device(fc, vec.mids, vec.ios, rng("groth16_keygen"),
                            "cpu")
proof = gd.prove_device(crs, fc, wm, rng("groth16_prove"))
assert gd.verify(vec.public(), gvk, proof)
assert vectors.proof_hex(proof, "groth16") == vec.proofs["groth16"]
# Pinocchio NonZK is left to tests/test_torch_pinocchio.py: its MSMs are
# a subset of the ZK prove's, and the plain versions are slow
pk, pvk = pd.keygen_device(fc, vec.mids, vec.ios, rng("pinocchio_keygen"),
                           "cpu")
proof = pd.prove_device(pk, fc, wm, rng("pinocchio_prove"), zk=True)
assert pd.verify(vec.public(), pvk, proof)
assert (vectors.proof_hex(proof, "pinocchio_zk")
        == vec.proofs["pinocchio_zk"])
blocked = ("jax", "zukelang_tpu")
assert not [m for m in sys.modules if m.split(".")[0] in blocked
            and sys.modules[m] is not None]
assert all(v == 0 for v in kernels.LAUNCHES.values())
print("NOJAX-OK")
"""


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_package_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    assert [p for p in _sources() if pat.search(open(p).read())] == []


def test_port_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+zukelang_tpu(\.|\s|$)", re.M)
    assert [p for p in _sources() if pat.search(open(p).read())] == []
    # nor load its library or switch the pairing through its variable
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "libzukelang_native" not in smoke
    assert "ZUKELANG_NATIVE_PAIRING" not in smoke


def test_small_circuit_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX-OK" in res.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # alone in a directory, away from the repository, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
