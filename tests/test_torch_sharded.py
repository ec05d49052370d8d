"""The port's multi-rank slice (`zukelang_tpu_torch/parallel/`) against the
JAX package's `parallel/sharded.py` on its 8-device CPU mesh
(`tests/conftest.py`), the port's single-rank functions and the golden
oracle, on the same seeded inputs.

Each world is made once: D = 1 in this process (gloo), D = 2 and D = 4
spawned by `launch.spawn` (gloo ranks that import only the port; their
inputs and outputs cross as numpy arrays, `testing/sharded_cases.py`),
both started when the module starts so that they run beside the D = 1
cases, as do the JAX references (in a thread).  Every case is its own test.  The sharded Groth16 and Pinocchio
ZK proves at D = 2 are the dry run's stages 1 and 2, held in
`tests/test_torch_scaling.py`; here Groth16 runs at D = 1 and
Pinocchio NonZK at D = 2 (logn 6, the windows pinned to 4).

Tolerance: exact (limb words, compressed points, proof bytes)."""

import random
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zukelang_tpu.ops import field_jax as FJ
from zukelang_tpu.parallel import sharded as jsh
from zukelang_tpu_torch import bench_lib
from zukelang_tpu_torch.engine import torch_engine as te
from zukelang_tpu_torch.golden.curve import G1, G2
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import field as F
from zukelang_tpu_torch.ops import ntt
from zukelang_tpu_torch.parallel import launch, sharded
from zukelang_tpu_torch.params import FR
from zukelang_tpu_torch.testing import sharded_cases

torch.set_num_threads(1)

TARGET = "zukelang_tpu_torch.testing.sharded_cases.run"
SPLITS = {"even": (3, 4), "odd": (4, 3)}     # (log1, log2) of 2^7 points
MSM_N = 64
STEP_S = 0x1234567      # the tau of the JAX entry point's ti1 table


def _np(t):
    return t.numpy()


@pytest.fixture(scope="module")
def inputs():
    """The JAX `test_sharded_gate_eval` construction (G = 64, K = 2,
    V = 16), a 2^7 vector for the NTTs, 2^6 G1 and G2 MSM terms."""
    G, K, V = 64, 2, 16
    r = random.Random(5)
    idx = np.random.RandomState(0).randint(0, V, size=(G, K)).astype(
        np.int32)
    coefs = [r.randrange(FR.p) for _ in range(G * K)]
    wvals = [r.randrange(FR.p) for _ in range(V + 1)]
    x = [r.randrange(FR.p) for _ in range(128)]
    g1, g2 = G1.generator(), G2.generator()
    pts1 = [g1 * r.randrange(1, 1 << 30) for _ in range(MSM_N)]
    pts2 = [g2 * r.randrange(1, 1 << 30) for _ in range(MSM_N)]
    sc = [r.randrange(FR.p) for _ in range(MSM_N)]
    return dict(
        idx=idx, coef_j=np.asarray(FJ.pack_mont(coefs, FJ.FR)).reshape(
            -1, G, K), w_j=np.asarray(FJ.pack_mont(wvals, FJ.FR)),
        x=[int(v) for v in x], pts1=pts1, pts2=pts2, sc=sc)


def _port(inp):
    return dict(idx=inp["idx"],
                coef=_np(F.from_jax(inp["coef_j"], axis=0)),
                w=_np(F.from_jax(inp["w_j"])),
                x=_np(F.pack_mont(inp["x"], FR)))


def _cases(inp, D):
    p = _port(inp)
    cases = [("gate", "gate_eval", dict(idx=p["idx"], coef=p["coef"],
                                        w=p["w"]))]
    for name, (l1, l2) in SPLITS.items():
        cases.append((f"ntt_{name}", "ntt", dict(
            x=p["x"].reshape(FR.nl, 1 << l1, 1 << l2), log1=l1, log2=l2)))
    l1, l2 = SPLITS["odd"]
    cases += [("intt", "intt", dict(x=p["x"], log1=l1, log2=l2)),
              ("phases", "phase_times", dict(
                  x=p["x"].reshape(FR.nl, 1 << l1, 1 << l2), log1=l1,
                  log2=l2))]
    if D == 2:
        S = _np(F.pack(inp["sc"], FR))
        for group, pts in (("g1", inp["pts1"]), ("g2", inp["pts2"])):
            P = tuple(_np(v) for v in C.pack_affine(pts, group))
            cases.append((f"msm_{group}", "msm", dict(
                points=P, scalars=S, group=group, c=4)))
        cases.append(("msm_low", "msm", dict(
            points=tuple(_np(v) for v in C.pack_affine(inp["pts1"], "g1")),
            scalars=S, group="g1", c=4, max_windows=2)))
        cases += [("window", "msm_window", dict(
                      points=tuple(_np(v) for v in C.pack_affine(
                          inp["pts1"], "g1")),
                      digits=np.array([s & 0xF for s in inp["sc"]],
                                      dtype=np.int32), c=4, group="g1")),
                  ("fb", "fixed_base", dict(scalars=S, group="g1", c=4)),
                  ("step", "prove_step", dict(logn=6, seed=1, s=STEP_S,
                                              max_windows=2))]
        cases += [(f"red{logn}", "reduction", dict(logn=logn, seed=1))
                  for logn in (6, 7)]
        cases.append(("pin", "pinocchio", dict(logn=6, seed=3,
                                               zks=(False,))))
        # last: rank 1 runs these while rank 0 runs the prove's reference
        for group, pts in (("g1", inp["pts1"]), ("g2", inp["pts2"])):
            cases.append((f"whole_{group}", "msm_whole", dict(
                points=tuple(_np(v) for v in C.pack_affine(pts, group)),
                scalars=S, group=group, c=4)))
    return cases


def _jax_refs(inp):
    """The JAX package's sharded gate evaluation and four-step NTT on its
    CPU mesh, converted to the port's limbs: {(name, D): array}."""
    out = {}
    for D in (2, 4):
        mesh = jsh.make_mesh(D)
        jev = jsh.sharded_gate_eval(mesh, jnp.asarray(inp["idx"]),
                                    jnp.asarray(inp["coef_j"]),
                                    jnp.asarray(inp["w_j"]))
        out["gate", D] = _np(F.from_jax(np.asarray(jev)))
        for split, (l1, l2) in SPLITS.items():
            xj = FJ.pack_mont(inp["x"], FJ.FR).reshape(-1, 1 << l1, 1 << l2)
            out[split, D] = _np(F.from_jax(np.asarray(
                jsh.sharded_ntt(mesh, xj, l1, l2)), axis=0))
    return out


@pytest.fixture(scope="module", autouse=True)
def worlds(inputs):
    """Futures started at module start: D -> every rank's results of the
    worlds of 2 and 4 ranks, and "jax" -> `_jax_refs` (in a thread: XLA
    compiles beside the test process's own cases)."""
    pool = ThreadPoolExecutor(3)
    futs = {D: pool.submit(launch.spawn, TARGET, D, "cpu", _cases(inputs, D))
            for D in (2, 4)}
    futs["jax"] = pool.submit(_jax_refs, inputs)
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world1():
    with launch.init_world1("cpu") as mesh:
        yield mesh


def _gathered(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def test_twiddle_matrix_equals_jax_word_for_word():
    for inverse in (False, True):
        want = F.from_jax(np.asarray(jsh._twiddle_matrix(3, 4, inverse)),
                          axis=0)
        got = sharded._twiddle_matrix(3, 4, inverse)
        assert np.array_equal(got.view(np.int32), _np(want))


def test_make_mesh_refuses_nccl_without_cuda():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with launch.init_world1():
            pass
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch.spawn(TARGET, 2, None, [])


def test_a_rank_that_raises_makes_spawn_raise():
    idx = np.zeros((3, 1), dtype=np.int32)
    coef = np.zeros((FR.nl, 3, 1), dtype=np.int32)
    w = np.zeros((FR.nl, 2), dtype=np.int32)
    with pytest.raises(RuntimeError, match="do not split over 2 ranks"):
        launch.spawn(TARGET, 2, "cpu",
                     [("gate", "gate_eval", dict(idx=idx, coef=coef, w=w))])


def test_sharded_groth16_prove_one_rank(world1):
    got = sharded_cases._groth16(world1, 6, 3)
    assert np.array_equal(got["proof"], got["reference"])
    assert bool(got["verified"])
    assert world1.counts["all_to_all"] == 3
    assert world1.counts["all_gather"] == 6


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_gate_eval_equals_jax_and_plain(inputs, worlds, D):
    got = _gathered(worlds[D].result(), "gate.block", 1)
    assert np.array_equal(got, worlds["jax"].result()["gate", D])
    p = _port(inputs)
    plain = ntt._gate_eval_plain(torch.from_numpy(p["idx"]),
                                 torch.from_numpy(p["coef"]),
                                 torch.from_numpy(p["w"]))
    assert np.array_equal(got, _np(plain))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_sharded_ntt_equals_jax_word_for_word(inputs, worlds, D, split):
    l1, l2 = SPLITS[split]
    got = _gathered(worlds[D].result(), f"ntt_{split}.block", 2)
    assert got.shape == (FR.nl, 1 << l2, 1 << l1)
    assert np.array_equal(got, worlds["jax"].result()[split, D])


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_intt_gives_natural_order(inputs, worlds, D):
    got = _gathered(worlds[D].result(), "intt.block", 2).reshape(FR.nl, -1)
    x = F.pack_mont(inputs["x"], FR)
    assert np.array_equal(got, _np(ntt.intt_plain(x)))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ntt_phase_times_keys(worlds, D):
    for r in worlds[D].result():
        times = {k.split(".", 1)[1]: float(v) for k, v in r.items()
                 if k.startswith("phases.")}
        assert set(times) == {"col_ntt_s", "twiddle_s", "all_to_all_s",
                              "row_ntt_s", "total_s"}
        assert all(v >= 0 for v in times.values())


@pytest.mark.parametrize("logn", [6, 7])
def test_sharded_witness_reduction_equals_single_rank(worlds, logn):
    """logn 7 splits 2^4 x 2^3: the explicit reshard between transforms."""
    inst = bench_lib.make_synthetic_r1cs(logn, seed=1)
    want = te.run_witness_reduction(inst.fc, inst.pack_witness("cpu"))
    for r in worlds[2].result():
        for name, w in zip("abh", want):
            assert np.array_equal(r[f"red{logn}.{name}"], _np(w)), name


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_sharded_msm_equals_golden_and_msm_g(inputs, worlds, group):
    """`msm_g1` / `msm_g2` on the same affine bases ran on the last rank,
    beside the other rank's references."""
    pts = inputs["pts1" if group == "g1" else "pts2"]
    golden = (G1 if group == "g1" else G2).dot(pts, [Fr(s)
                                                     for s in inputs["sc"]])
    ranks = worlds[2].result()
    assert bytes(ranks[-1][f"whole_{group}.point"]) == \
        golden.to_compressed_bytes()
    for r in ranks:
        assert bytes(r[f"msm_{group}.point"]) == golden.to_compressed_bytes()


def test_sharded_msm_max_windows_is_the_low_bits(inputs, worlds):
    low = G1.dot(inputs["pts1"], [Fr(s & 0xFF) for s in inputs["sc"]])
    for r in worlds[2].result():
        assert bytes(r["msm_low.point"]) == low.to_compressed_bytes()


def test_sharded_msm_window_equals_golden(inputs, worlds):
    want = G1.dot(inputs["pts1"], [Fr(s & 0xF) for s in inputs["sc"]])
    for r in worlds[2].result():
        assert bytes(r["window.point"]) == want.to_compressed_bytes()


def test_sharded_fixed_base_blocks(inputs, worlds):
    got = _gathered(worlds[2].result(), "fb.block", -1)
    g = G1.generator()
    assert C.unpack_g1(tuple(torch.from_numpy(got))) == [
        g * Fr(s) for s in inputs["sc"]]


def test_sharded_prove_step_equals_golden(worlds):
    """The l side's iNTT coefficients (the reduction's a) over {g s^i},
    the low 8 bits (max_windows = 2, c = 4)."""
    inst = bench_lib.make_synthetic_r1cs(6, seed=1)
    a, _b, _h = te.run_witness_reduction(inst.fc, inst.pack_witness("cpu"))
    g, r = G1.generator(), FR.p
    want = G1.dot([g * Fr(pow(STEP_S, i, r)) for i in range(64)],
                  [Fr(v & 0xFF) for v in F.unpack_mont(a, FR)])
    for rk in worlds[2].result():
        assert bytes(rk["step.point"]) == want.to_compressed_bytes()


def test_sharded_pinocchio_nonzk_prove_two_ranks(worlds):
    """The ZK prove is the dry run's stage 2; the all-variable tail is
    non-empty at this size (V = 66 variables, tables of 64)."""
    r0, r1 = worlds[2].result()
    assert np.array_equal(r0["pin.nonzk.proof"], r1["pin.nonzk.proof"])
    assert np.array_equal(r0["pin.nonzk.proof"], r0["pin.nonzk.reference"])
    assert bool(r0["pin.nonzk.verified"])
    assert int(r0["pin.tail"]) == 2
