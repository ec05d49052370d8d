"""The port's Groth16 (keygen, prove, verify) against the golden protocol
and the JAX package: proof bytes under the same injected scalars, CRS
points, the keypair file format, and the synthetic R1CS builder.

Tolerance: exact (bytes, golden points, limbs after repacking)."""

import numpy as np
import pytest
import torch

from zukelang_tpu import bench_lib as jbench
from zukelang_tpu.core import comp, lang as L, qap as qap_mod
from zukelang_tpu.golden import G1, G2, pairing
from zukelang_tpu.golden.field import Fr
from zukelang_tpu.ops import curve_jax as CJ
from zukelang_tpu.protocols import groth16_device as jgd
from zukelang_tpu.protocols.groth16 import Groth16
from zukelang_tpu.rng import Gen, InjectedRng
from zukelang_tpu_torch import bench_lib
from zukelang_tpu_torch import rng as trng
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.protocols import groth16_device as gd

from jax_flat import assert_side_matches_jax

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

KEY_SCALARS = [Fr(i + 1000) for i in range(5)]
PROVE_SCALARS = [Fr(77), Fr(88)]


def _port_rng(scalars):
    """The same scalar stream for the port (its own Fr class)."""
    return trng.InjectedRng([s.n for s in scalars])


def _b(points):
    """Points of either package -> their compressed bytes: the port's
    classes are its own, so points compare across packages by encoding."""
    return [p.to_compressed_bytes() for p in points]


def _instance():
    e = L.let_(L.input("input", L.SECRET, L.ty_field),
               lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))
    c = comp.compile_expr(e)
    q = qap_mod.build(c.gates, domain="ntt")
    _i, _env_lang, env_code = comp.gen_inputs(c.inputs, Gen(3))
    return c, q, comp.code_eval_list(env_code, c.codes)


@pytest.fixture(scope="module")
def small():
    """x^3 + x + 3: golden and port keygen + prove, windows pinned to 4."""
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        c, q, sol = _instance()
        proto = Groth16()
        pk, vk = proto.keygen(InjectedRng(KEY_SCALARS), c.circuit, q)
        golden = proto.prove(InjectedRng(PROVE_SCALARS), q, pk, sol)
        fc = flat.flatten(c.gates)
        crs, dvk = gd.keygen_device(
            fc, mids=list(c.circuit.mids),
            ios=list(c.circuit.inputs_public | c.circuit.outputs),
            rng=_port_rng(KEY_SCALARS), device="cpu")
        proof = gd.prove_device(crs, fc, fc.pack_witness(sol),
                                _port_rng(PROVE_SCALARS))
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved
    return dict(c=c, sol=sol, proto=proto, pk=pk, vk=vk, golden=golden,
                fc=fc, crs=crs, dvk=dvk, proof=proof)


def test_proof_bytes_equal_golden_groth16(small):
    for part in ("a", "b", "c"):
        assert (getattr(small["proof"], part).to_compressed_bytes()
                == getattr(small["golden"], part).to_compressed_bytes())


def test_proof_verifies_with_both_keys(small):
    c, sol = small["c"], small["sol"]
    public = {v: f for v, f in sol.items() if v not in c.circuit.mids}
    assert gd.verify(public, small["dvk"], small["proof"])
    assert small["proto"].verify(public, small["vk"], small["proof"])
    bad = dict(public)
    k = next(iter(bad))
    bad[k] = bad[k] + Fr(1)
    assert not gd.verify(bad, small["dvk"], small["proof"])


def test_crs_points_match_golden_pkey(small):
    pk, crs, n = small["pk"], small["crs"], small["crs"].n
    assert _b(C.unpack_g1(C.affine_to_jac(crs.ti1))[:n]) == _b(pk.ti1[:n])
    assert _b(C.unpack_g2(C.affine_to_jac(crs.ti2))[:n]) == _b(pk.ti2[:n])
    assert _b(C.unpack_g1(C.affine_to_jac(crs.tiztd))[:n - 1]) == _b(pk.tiztd)
    mids = sorted(pk.ltd_mid)
    assert (_b(C.unpack_g1(C.affine_to_jac(crs.ltd_mid))[:len(mids)])
            == _b([pk.ltd_mid[k] for k in mids]))
    assert small["dvk"].ab.to_bytes() == small["vk"].ab.to_bytes()


def _jax_style_crs():
    """A small CRS as tests/test_device_groth16.py builds one."""
    g1, g2 = G1.generator(), G2.generator()

    def aff(pack, g, ks):
        p = pack([g * k for k in ks])
        return (p[0], p[1])

    crs = jgd.DeviceCRS(
        alpha_g1=g1 * 11, beta_g1=g1 * 12, beta_g2=g2 * 13,
        delta_g1=g1 * 14, delta_g2=g2 * 15,
        ti1=aff(CJ.pack_g1, g1, [1, 2, 3, 4]),
        ti2=aff(CJ.pack_g2, g2, [1, 2, 3, 4]),
        ltd_mid=aff(CJ.pack_g1, g1, [5, 6]),
        tiztd=aff(CJ.pack_g1, g1, [7, 8, 9]),
        mids_idx=np.array([2, 3], dtype=np.int32), n=4)
    vkey = jgd.DeviceVKey(
        one1=g1, ltgm_io={0: g1 * 21, 5: g1 * 22}, one2=g2,
        gm=g2 * 23, d=g2 * 24, ab=pairing(g1 * 3, g2 * 5),
        alpha_g1=g1 * 11, beta_g2=g2 * 13)
    return crs, vkey


def test_load_keypair_reads_jax_file(tmp_path):
    jcrs, jvk = _jax_style_crs()
    path = str(tmp_path / "jax_keypair.npz")
    jgd.save_keypair(path, jcrs, jvk)
    fc = flat.flatten(_instance()[0].gates)
    assert fc.domain_size == 4
    crs, vkey = gd.load_keypair(path, fc, device="cpu")
    want = gd.crs_from_jax(jcrs, device="cpu")
    for name in ("ti1", "ti2", "ltd_mid", "tiztd"):
        for a, b, j in zip(getattr(crs, name), getattr(want, name),
                           getattr(jcrs, name)):
            assert torch.equal(a, b)
            assert np.array_equal(F.to_jax(a), np.asarray(j))
    assert crs.n == 4 and np.array_equal(crs.mids_idx, jcrs.mids_idx)
    for name in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert _b([getattr(crs, name), getattr(want, name)]) == _b(
            [getattr(jcrs, name)] * 2)
    assert vkey.ab.to_bytes() == jvk.ab.to_bytes()
    assert {k: _b([p]) for k, p in vkey.ltgm_io.items()} == {
        k: _b([p]) for k, p in jvk.ltgm_io.items()}
    assert _b([vkey.gm, vkey.beta_g2]) == _b([jvk.gm, jvk.beta_g2])


def test_load_keypair_checks_the_circuit_domain(tmp_path):
    jcrs, jvk = _jax_style_crs()
    jcrs.n = 8
    path = str(tmp_path / "wrong_domain.npz")
    jgd.save_keypair(path, jcrs, jvk)
    fc = flat.flatten(_instance()[0].gates)
    with pytest.raises(ValueError, match="domain"):
        gd.load_keypair(path, fc, device="cpu")


def test_save_keypair_is_read_back_by_both_packages(tmp_path, small):
    import dataclasses
    path = str(tmp_path / "port_keypair.npz")
    # the file format keys ios by integer column, as the JAX loader reads it
    dvk = dataclasses.replace(small["dvk"], ltgm_io={
        i: p for i, p in enumerate(small["dvk"].ltgm_io.values())})
    gd.save_keypair(path, small["crs"], dvk)
    jcrs, jvk = jgd.load_keypair(path)
    crs, vkey = gd.load_keypair(path, small["fc"], device="cpu")
    for name in ("ti1", "ti2", "ltd_mid", "tiztd"):
        for a, b, j in zip(getattr(small["crs"], name), getattr(crs, name),
                           getattr(jcrs, name)):
            assert torch.equal(a, b)
            assert np.array_equal(F.to_jax(a), np.asarray(j))
    assert jvk.ab.to_bytes() == small["dvk"].ab.to_bytes()
    assert vkey.d == small["dvk"].d


@pytest.mark.parametrize("log_constraints", [5, 6])
def test_synthetic_r1cs_matches_jax(log_constraints):
    j = jbench.make_synthetic_r1cs(log_constraints, seed=1)
    t = bench_lib.make_synthetic_r1cs(log_constraints, seed=1)
    assert t.witness == j.witness
    assert np.array_equal(t.mids_cols, j.mids_cols)
    assert np.array_equal(t.ios_cols, j.ios_cols)
    assert t.fc.logn == j.fc.logn and t.fc.n_gates == j.fc.n_gates
    for name in ("l", "r", "lhs"):
        assert_side_matches_jax(getattr(j.fc, name), getattr(t.fc, name),
                                len(j.fc.vars_sorted))
    assert np.array_equal(F.to_jax(t.pack_witness()), np.asarray(j.pack_witness()))


@pytest.mark.slow
def test_keygen_and_prove_match_jax_device(monkeypatch):
    """CRS arrays and proof against the JAX package's device Groth16 at
    window 4 (slow, as tests/test_device_groth16.py's device test is)."""
    import jax.numpy as jnp
    from zukelang_tpu.core import flat as jflat
    for mod in (gd, jgd):
        monkeypatch.setattr(mod, "DEFAULT_MSM_WINDOW", 4)
        monkeypatch.setattr(mod, "DEFAULT_FB_WINDOW", 4)
    c, _q, sol = _instance()
    ios = list(c.circuit.inputs_public | c.circuit.outputs)
    fj = jflat.flatten(c.gates)
    jcrs, _ = jgd.keygen_device(fj, mids=list(c.circuit.mids), ios=ios,
                                rng=InjectedRng(KEY_SCALARS))
    jproof = jgd.prove_device(jcrs, fj, jnp.asarray(fj.pack_witness(sol)),
                              InjectedRng(PROVE_SCALARS))
    fc = flat.flatten(c.gates)
    crs, _ = gd.keygen_device(fc, mids=list(c.circuit.mids), ios=ios,
                              rng=_port_rng(KEY_SCALARS), device="cpu")
    for name in ("ti1", "ti2", "ltd_mid", "tiztd"):
        for a, j in zip(getattr(crs, name), getattr(jcrs, name)):
            w = np.asarray(j).shape[-1]
            assert np.array_equal(F.to_jax(a)[..., :w], np.asarray(j))
            assert not a[..., w:].any()          # padding is infinity
    proof = gd.prove_device(gd.crs_from_jax(jcrs, device="cpu"), fc,
                            fc.pack_witness(sol), _port_rng(PROVE_SCALARS))
    for part in ("a", "b", "c"):
        assert (getattr(proof, part).to_compressed_bytes()
                == getattr(jproof, part).to_compressed_bytes())
