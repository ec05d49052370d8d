"""The port's bench against the JAX package's at 2^6 on the CPU (windows
4, no canonical padding): the JAX `bench_groth16` runs keygen, proves
and verify and writes its keypair checkpoint; the port's keygen from the
same `Gen` seed gives the same CRS; the port's `bench_groth16`, resumed
from the JAX checkpoint, returns the JAX dict's keys and counts, and its
proofs equal the JAX bench's point for point.

The JAX device path compiles its programs here (about four minutes), so
this file holds only what needs it.

Tolerance: exact (CRS limbs after repacking, proof bytes)."""

import numpy as np
import pytest
import torch

from zukelang_tpu import bench_lib as jbench
from zukelang_tpu.protocols import groth16_device as jgd
from zukelang_tpu_torch import bench_lib
from zukelang_tpu_torch import rng as trng
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.protocols import groth16_device as gd

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)


def _keep_proofs(mp, module, proofs):
    """Keep every proof `module.prove_device` returns."""
    orig = module.prove_device

    def prove(*a, **k):
        proofs.append(orig(*a, **k))
        return proofs[-1]
    mp.setattr(module, "prove_device", prove)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("bench_jax") / "jax_crs")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (gd, jgd):
            mp.setattr(mod, "DEFAULT_MSM_WINDOW", 4)
            mp.setattr(mod, "DEFAULT_FB_WINDOW", 4)
        mp.setenv("BENCH_CANON_LOG", "0")
        mp.setenv("ZUKELANG_CRS_CHECKPOINT", ckpt)
        jproofs, proofs = [], []
        _keep_proofs(mp, jgd, jproofs)
        jres = jbench.bench_groth16(6, repeats=1)
        inst = bench_lib.make_synthetic_r1cs(6, seed=1, pad_log=6)
        crs, vkey = gd.keygen_device(
            inst.fc, mids=list(inst.mids_cols), ios=list(inst.ios_cols),
            rng=trng.Gen(b"bench-keygen"), device="cpu")
        _keep_proofs(mp, gd, proofs)
        progress = {}
        res = bench_lib.bench_groth16(6, repeats=1, device="cpu",
                                      progress=progress)
    return dict(jres=jres, jproofs=jproofs, crs=crs, vkey=vkey, res=res,
                proofs=proofs, progress=progress, ckpt=ckpt + ".npz")


def test_bench_dict_has_the_jax_keys_and_counts(both):
    res, jres = both["res"], both["jres"]
    assert set(res) == set(jres)
    assert res["verified"] and jres["verified"]
    for key in ("log_constraints", "domain_log", "msm_terms_per_prove"):
        assert res[key] == jres[key], key


def test_jax_checkpoint_resumes_the_port_bench(both):
    assert both["progress"]["resumed_from_checkpoint"] is True


def test_port_keygen_equals_the_jax_checkpoint(both):
    jcrs, jvk = jgd.load_keypair(both["ckpt"])
    crs, vkey = both["crs"], both["vkey"]
    for name in ("ti1", "ti2", "ltd_mid", "tiztd"):
        for a, j in zip(getattr(crs, name), getattr(jcrs, name)):
            w = np.asarray(j).shape[-1]
            assert np.array_equal(F.to_jax(a)[..., :w], np.asarray(j)), name
            assert not a[..., w:].any(), name           # padding: infinity
    assert np.array_equal(crs.mids_idx, jcrs.mids_idx) and crs.n == jcrs.n
    for name in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert (getattr(crs, name).to_compressed_bytes()
                == getattr(jcrs, name).to_compressed_bytes()), name
    assert vkey.ab.to_bytes() == jvk.ab.to_bytes()
    assert ({int(k): p.to_compressed_bytes() for k, p in vkey.ltgm_io.items()}
            == {k: p.to_compressed_bytes() for k, p in jvk.ltgm_io.items()})


def test_proofs_equal_the_jax_bench_proofs(both):
    """The cold prove (`Gen(b"bench-prove")`) and the warm one
    (`Gen(b"bench-prove-0")`) of each bench, point for point."""
    assert len(both["proofs"]) == len(both["jproofs"]) == 2
    for proof, jproof in zip(both["proofs"], both["jproofs"]):
        for part in ("a", "b", "c"):
            assert (getattr(proof, part).to_compressed_bytes()
                    == getattr(jproof, part).to_compressed_bytes()), part
