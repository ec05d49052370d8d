"""The port's Pinocchio (keygen, NonZK and ZK prove, verify) against the
JAX package's golden `Pinocchio` on x^3 + x + 3 under the same injected
scalars (the model is tests/test_device_pinocchio.py, whose device run is
slow): proof bytes, verifying key, proving-key points, and the reading of
a JAX-package `DevicePKey`.

Tolerance: exact (proof and point bytes, limbs after repacking)."""

import numpy as np
import pytest
import torch

from zukelang_tpu.core import comp, lang as L, qap as qap_mod
from zukelang_tpu.golden.curve import G1 as JG1, G2 as JG2
from zukelang_tpu.golden.field import Fr
from zukelang_tpu.protocols import pinocchio_device as jpd
from zukelang_tpu.protocols.pinocchio import Pinocchio
from zukelang_tpu.rng import Gen, InjectedRng
from zukelang_tpu_torch import rng as trng
from zukelang_tpu_torch.core import flat
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.protocols import groth16_device as gd
from zukelang_tpu_torch.protocols import pinocchio_device as pd

# The plain versions run thousands of small int64 ops: intra-op threads
# only add overhead there and oversubscribe the test workers' cores.
torch.set_num_threads(1)

KEY_SCALARS = [i + 2000 for i in range(8)]
PROVE_SCALARS = [71, 72, 73]
FIELDS = ("vv", "ww", "yy", "h", "vavv", "waww", "yayy", "bvwy")


def _b(points):
    """Points of either package -> their compressed bytes: the port's
    classes are its own, so points compare across packages by encoding."""
    return [p.to_compressed_bytes() for p in points]


@pytest.fixture(scope="module")
def small():
    """Golden and port keygen, NonZK and ZK proves; windows pinned to 4."""
    e = L.let_(L.input("input", L.SECRET, L.ty_field),
               lambda x: L.add(L.add(L.mul(L.mul(x, x), x), x), L.fnum(3)))
    c = comp.compile_expr(e)
    q = qap_mod.build(c.gates, domain="ntt")
    _i, _env_lang, env_code = comp.gen_inputs(c.inputs, Gen(3))
    sol = comp.code_eval_list(env_code, c.codes)
    jrng = lambda xs: InjectedRng([Fr(x) for x in xs])   # noqa: E731
    pk, vk = Pinocchio().keygen(jrng(KEY_SCALARS), c.circuit, q)
    golden = {zk: Pinocchio(zk=zk).prove(jrng(PROVE_SCALARS), q, pk, sol)
              for zk in (False, True)}
    saved = gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW
    gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = 4, 4
    try:
        fc = flat.flatten(c.gates)
        dpk, dvk = pd.keygen_device(
            fc, mids=list(c.circuit.mids),
            ios=list(c.circuit.inputs_public | c.circuit.outputs),
            rng=trng.InjectedRng(KEY_SCALARS), device="cpu")
        wm = fc.pack_witness(sol)
        proofs = {zk: pd.prove_device(dpk, fc, wm,
                                      trng.InjectedRng(PROVE_SCALARS), zk=zk)
                  for zk in (False, True)}
    finally:
        gd.DEFAULT_MSM_WINDOW, gd.DEFAULT_FB_WINDOW = saved
    public = {v: f for v, f in sol.items() if v not in c.circuit.mids}
    return dict(c=c, pk=pk, vk=vk, golden=golden, dpk=dpk, dvk=dvk,
                proofs=proofs, public=public)


@pytest.mark.parametrize("zk", [False, True], ids=["nonzk", "zk"])
def test_proof_bytes_equal_golden_pinocchio(small, zk):
    got, want = small["proofs"][zk], small["golden"][zk]
    assert (_b([getattr(got, f) for f in FIELDS])
            == _b([getattr(want, f) for f in FIELDS]))


@pytest.mark.parametrize("zk", [False, True], ids=["nonzk", "zk"])
def test_proof_verifies_and_a_wrong_input_does_not(small, zk):
    proof, public = small["proofs"][zk], small["public"]
    assert pd.verify(public, small["dvk"], proof)
    assert Pinocchio(zk=zk).verify(public, small["vk"], proof)
    bad = dict(public)
    k = next(iter(bad))
    bad[k] = bad[k] + Fr(1)
    assert not pd.verify(bad, small["dvk"], proof)


def test_vkey_points_equal_golden(small):
    dvk, vk = small["dvk"], small["vk"]
    names = ("one", "one2", "av", "aw", "ay", "gm2", "bgm", "bgm2", "yt")
    assert (_b([getattr(dvk, k) for k in names])
            == _b([getattr(vk, k) for k in names]))
    for m in ("vv_io", "ww_io", "yy_io"):
        got, want = getattr(dvk, m), getattr(vk, m)
        assert sorted(got) == sorted(want)
        assert _b([got[k] for k in sorted(got)]) == _b(
            [want[k] for k in sorted(want)])


def test_pkey_points_equal_golden(small):
    dpk, pk = small["dpk"], small["pk"]
    mids = sorted(pk.vv)
    for name in ("vv", "ww", "yy", "vav", "waw", "yay", "bvwy"):
        batch = getattr(dpk, name)
        unpack = C.unpack_g2 if batch[0].dim() == 3 else C.unpack_g1
        got = unpack(C.affine_to_jac(batch))[:len(mids)]
        assert _b(got) == _b([getattr(pk, name)[k] for k in mids]), name
    n = dpk.n
    assert _b(C.unpack_g1(C.affine_to_jac(dpk.si))[:n]) == _b(pk.si[:n])
    assert _b(C.unpack_g2(C.affine_to_jac(dpk.si2))[:n]) == _b(pk.si2[:n])
    allv = sorted(pk.v_all)
    for name in ("v_all", "w_all"):
        got = C.unpack_g1(C.affine_to_jac(getattr(dpk, name)))[:len(allv)]
        assert _b(got) == _b([getattr(pk, name)[k] for k in allv]), name
    singles = ("vt", "wt", "yt", "vavt", "wawt", "yayt", "vbt", "wbt", "ybt")
    assert (_b([getattr(dpk, k) for k in singles])
            == _b([getattr(pk, k) for k in singles]))
    assert dpk.v_all_tail == [] and dpk.w_all_tail == []


def test_pkey_from_jax_reads_a_jax_device_pkey(small):
    """A JAX-package DevicePKey (numpy arrays in 16-bit limbs, its own
    golden points) made from the port's key reads back to that key."""
    dpk = small["dpk"]
    g1 = JG1.generator()

    def jpoint(p):
        raw = p.to_compressed_bytes()
        return (JG1 if len(raw) == 48 else JG2).of_compressed_bytes(raw)

    fields = {name: C.to_jax(getattr(dpk, name)) for name in pd._BATCHES}
    fields.update({name: jpoint(getattr(dpk, name)) for name in pd._SINGLES})
    jpk = jpd.DevicePKey(**fields, v_all_tail=[g1 * 5], w_all_tail=[g1 * 6],
                         mids_idx=dpk.mids_idx.astype(np.int32), n=dpk.n)
    got = pd.pkey_from_jax(jpk, device="cpu")
    for name in pd._BATCHES:
        for a, b, j in zip(getattr(got, name), getattr(dpk, name),
                           getattr(jpk, name)):
            assert torch.equal(a, b)
            assert np.array_equal(F.to_jax(a), j)
    assert (_b([getattr(got, k) for k in pd._SINGLES])
            == _b([getattr(dpk, k) for k in pd._SINGLES]))
    assert _b(got.v_all_tail + got.w_all_tail) == _b([g1 * 5, g1 * 6])
    assert np.array_equal(got.mids_idx, dpk.mids_idx) and got.n == dpk.n
