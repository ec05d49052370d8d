#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its paths on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; build the CUDA kernels from
     zukelang_tpu_torch/csrc (one nvcc per source, sm_90a) and the port's
     native pairing (zukelang_tpu_torch/hostsrc, the host C++ compiler),
     both at once, and report their build times;
  2. every kernel against its plain PyTorch version on the card, at the
     paths' shapes; integer outputs must be equal; times from CUDA events
     after a warm-up, beside each kernel's bound (bytes or operations);
  3. the frozen x^3 + x + 3 vectors (zukelang_tpu_torch/testdata): keygen,
     prove and verify of Groth16, Pinocchio NonZK and Pinocchio ZK under
     the injected scalars; the proof bytes must equal the golden ones;
  4. Groth16 at 2^16: keygen, prove (one cold, three warm) and verify on
     make_synthetic_r1cs(16, seed=1), every kernel launch counted;
  5. Pinocchio at the JAX bench's size: make_synthetic_r1cs(14, seed=1)
     on its 2^16 domain (`bench_lib.run_pinocchio`): keygen, ZK proves
     (one cold, three warm), verify; then one NonZK prove and its verify,
     and one more ZK prove, every kernel launch counted.
Phases 4 and 5 also print the launches of one prove.
Each path of phases 4 and 5 starts from zeroed counts; every kernel of
the path must have launched in it, and K3 in both keygens.  Then one JSON
line with the kernel summaries, the card line, and the last line
{"ok": true, "device": {...}}.

Without CUDA it stops at once with a non-zero exit and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.modules["jax"] = None           # any JAX import below fails loudly
sys.modules["zukelang_tpu"] = None  # and so does any import of the JAX package

LOG_CONSTRAINTS = 16        # the bench headline groth16_prove_2^16
PIN_LOG_CONSTRAINTS = 14    # the JAX bench's pinocchio_prove_2^14

# kernel -> (its CUDA source, the Pallas entry point it replaces)
REPLACES = {
    "mont_mul": ("zukelang_tpu_torch/csrc/mont_mul.cu",
                 "zukelang_tpu/ops/pallas_kernels.py:201"),
    "point_add": ("zukelang_tpu_torch/csrc/point_ops.cu",
                  "zukelang_tpu/ops/pallas_kernels.py:346"),
    "point_double": ("zukelang_tpu_torch/csrc/point_ops.cu",
                     "zukelang_tpu/ops/pallas_kernels.py:359"),
    "point_madd": ("zukelang_tpu_torch/csrc/point_ops.cu",
                   "zukelang_tpu/ops/pallas_kernels.py:663"),
    "digit_sort": ("zukelang_tpu_torch/csrc/digit_sort.cu",
                   "zukelang_tpu/ops/pallas_kernels.py:1173"),
    "bucket_scan_rows": ("zukelang_tpu_torch/csrc/bucket_scan.cu",
                         "zukelang_tpu/ops/pallas_kernels.py:1296"),
    "jac_scan": ("zukelang_tpu_torch/csrc/jac_scan.cu",
                 "zukelang_tpu/ops/pallas_kernels.py:986"),
    "weighted_chunk_sums": ("zukelang_tpu_torch/csrc/weighted_sums.cu",
                            "zukelang_tpu/ops/pallas_kernels.py:1455"),
}

# The least time the card could take: bytes over the HBM rate, and limb
# products over the integer rate.  NVIDIA's data sheet gives no 32-bit
# integer rate; an H100 SXM has 132 SMs of 64 INT32 lanes at up to
# 1.98 GHz, 16.7e12 32-bit multiply-adds per second.  One operation is one
# 32x32->64-bit limb product (its two halves take two issue slots on the
# card, so this bound is optimistic by up to 2x).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
# limb products of one CIOS Montgomery product: a*b and m*p (nl^2 each)
# plus the nl reduction digits; an Fq2 product is three Fq products
PRODUCTS = {"Fr": 2 * 8 * 8 + 8, "Fq": 2 * 12 * 12 + 12}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _timed(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> int:
    """Largest |difference| of the uint32 words (or ints) of two results."""
    import torch
    if isinstance(a, (tuple, list)):
        return max(_max_err(x, y) for x, y in zip(a, b))
    if a.dtype == torch.bool:
        return int((a != b).sum())
    x = a.to(torch.int64) & 0xFFFFFFFF
    y = b.to(torch.int64) & 0xFFFFFFFF
    return int((x - y).abs().max()) if x.numel() else 0


def _nbytes(*ts) -> int:
    """Bytes of tensors (nested tuples and lists allowed)."""
    total = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            total += _nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def _bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations
    / integer rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _fq_ops(group: str, fq_products) -> int:
    """Limb products of `fq_products` coordinate-field products."""
    return int(fq_products) * PRODUCTS["Fq"] * (3 if group == "g2" else 1)


def _zero_coord(c):
    """(N,) bool: the coordinate is 0 (G1 (12, N), G2 (2, 12, N))."""
    return (c.reshape(-1, c.shape[-1]) == 0).all(dim=0)


def _scan_adds(inf, restart):
    """Full adds a K7-style scan does: inf (K, M) input infinity per step,
    restart (K, M) where the accumulator restarts.  An add costs only
    when both operands are finite."""
    acc_inf, adds = inf[0], 0
    for t in range(1, inf.shape[0]):
        adds += int((~restart[t] & ~acc_inf & ~inf[t]).sum())
        acc_inf = inf[t].where(restart[t], acc_inf & inf[t])
    return adds


def _wsum_adds(inf):
    """Full adds of K6 on inf (K, M) (step t = element K-1-t): s += v,
    then w += s for all but the last step; w starts at infinity."""
    s_inf, w_inf, adds = inf[0], None, 0
    for t in range(inf.shape[0]):
        if t:
            adds += int((~s_inf & ~inf[t]).sum())
            s_inf = s_inf & inf[t]
        if t < inf.shape[0] - 1:
            if w_inf is not None:
                adds += int((~w_inf & ~s_inf).sum())
                w_inf = w_inf & s_inf
            else:
                w_inf = s_inf
    return adds


def kernel_checks(dev, rng: random.Random):
    import torch
    from zukelang_tpu_torch.ops import field as F
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.params import FQ, FR

    def rand_field(spec, n):
        return F.pack([rng.randrange(spec.p) for _ in range(n)], spec, dev)

    def rand_coord(group, n):
        if group == "g1":
            return rand_field(FQ, n)
        return torch.stack([rand_field(FQ, n), rand_field(FQ, n)])

    def rand_points(group, n, inf_every=17):
        X, Y, Z = (rand_coord(group, n) for _ in range(3))
        Z[..., ::inf_every] = 0                      # infinities
        return X, Y, Z

    results = {}

    def record(name, kern, plain, work, reps=20, plain_reps=2, library=None):
        """work(got) -> (bytes, operations) of this call."""
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        ms = _timed(kern, reps)
        plain_ms = _timed(plain, plain_reps)
        lib_ms = _timed(library, reps) if library is not None else None
        bound_ms, bound_by = _bound(*work(got))
        results.setdefault(name, []).append(dict(
            err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms))
        log(f"  {name}: max_abs_err {err}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})"
            + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with plain")

    n = 1 << 16
    for spec in (FR, FQ):
        a, b = rand_field(spec, n), rand_field(spec, n)
        log(f"K1 mont_mul {spec.name} (nl, 2^16)")
        record("mont_mul", lambda: K.mont_mul(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got), n * PRODUCTS[spec.name]))

    n2 = 1 << 12
    for group in ("g1", "g2"):
        P = rand_points(group, n2)
        Q = list(rand_points(group, n2))
        # P + P, P + (-P) and infinity operands among random lanes
        for i in range(3):
            Q[i][..., 1::5] = P[i][..., 1::5]
        Q[0][..., 2::5] = P[0][..., 2::5]
        Q[2][..., 2::5] = P[2][..., 2::5]
        negY = F.fq2_neg(P[1]) if group == "g2" else F.neg(P[1], FQ)
        Q[1][..., 2::5] = negY[..., 2::5]
        Q[2][..., 3::5] = 0
        Q = tuple(Q)
        finite = ~_zero_coord(P[2]) & ~_zero_coord(Q[2])
        equal = torch.stack([(a == b).reshape(-1, n2).all(0)
                             for a, b in zip(P, Q)]).all(0)
        # add-2007-bl: 16 products, 15 where P == Q (8 + the doubling's 7)
        add_products = int(16 * (finite & ~equal).sum()
                           + 15 * (finite & equal).sum())
        log(f"K2 point_add / point_double {group} (2^12)")
        record("point_add", lambda: K.point_add(P, Q),
               lambda: K.point_add_plain(P, Q),
               lambda got: (_nbytes(P, Q, got), _fq_ops(group, add_products)),
               plain_reps=1)
        record("point_double", lambda: K.point_double(P),
               lambda: K.point_double_plain(P),
               lambda got: (_nbytes(P, got), _fq_ops(group, 7 * n2)),
               plain_reps=1)

        # K3: Jacobian P + affine Q with infinity on both sides, P == Q
        # (flagged) and P == -Q lanes; at 2^12 and at the keygen path's
        # shape (a fixed-base batch of 16 lanes, one partial block)
        for nm in (n2, 16):
            one = F.ones_mont(nm, FQ, dev)
            if group == "g2":
                one = torch.stack([one, torch.zeros_like(one)])
            Pm = [x.clone() for x in rand_points(group, nm)]
            qx, qy = rand_coord(group, nm), rand_coord(group, nm)
            Pm[2][..., 1::5] = one[..., 1::5]
            qx[..., 1::5], qy[..., 1::5] = Pm[0][..., 1::5], Pm[1][..., 1::5]
            Pm[2][..., 2::5] = one[..., 2::5]
            qx[..., 2::5] = Pm[0][..., 2::5]
            negY = F.fq2_neg(Pm[1]) if group == "g2" else F.neg(Pm[1], FQ)
            qy[..., 2::5] = negY[..., 2::5]
            qx[..., 3::5] = 0
            qy[..., 3::5] = 0
            Pm, Qa = tuple(Pm), (qx, qy)
            p_inf = _zero_coord(Pm[2])
            q_inf = _zero_coord(qx) & _zero_coord(qy)
            if not (bool(p_inf.any()) and bool(q_inf.any())):
                raise AssertionError("point_madd: no infinity lanes")
            madd_lanes = int((~p_inf & ~q_inf).sum())
            log(f"K3 point_madd {group} ({nm} lanes)")
            record("point_madd", lambda: K.point_madd(Pm, Qa),
                   lambda: K.point_madd_plain(Pm, Qa),
                   lambda got: (_nbytes(Pm, Qa, got),
                                _fq_ops(group, 11 * madd_lanes)),
                   plain_reps=1)
            _got, flag = K.point_madd(Pm, Qa)
            if not bool(flag[1::5].all()) or bool(flag[2::5].any()):
                raise AssertionError("point_madd: doubling flag wrong")

    c = 13
    nb = (1 << (c - 1)) + 1
    digits = torch.randint(0, nb, (20, 1 << 16), dtype=torch.int32,
                           device=dev)
    log("K4 digit_sort (20 windows x 2^16 digits, c = 13)")
    record("digit_sort", lambda: K.digit_sort(digits, nb),
           lambda: K.digit_sort_plain(digits, nb),
           lambda got: (_nbytes(digits, got), 0),
           library=lambda: torch.sort(digits, dim=-1, stable=True))
    sk, order = K.digit_sort(digits, nb)
    if not torch.equal(torch.gather(digits, 1, order.long()), sk):
        raise AssertionError("digit_sort: keys[order] != sorted keys")

    Kc, M = 32, 2048
    for group in ("g1", "g2"):
        rows = 12 if group == "g1" else 24
        X = rand_coord(group, Kc * M).reshape(rows, Kc, M).transpose(0, 1)
        Y = rand_coord(group, Kc * M).reshape(rows, Kc, M).transpose(0, 1)
        pts3 = torch.cat([X, Y], dim=1).contiguous()      # (K, 2 rows, M)
        pts3[5, :, ::13] = 0                              # affine infinity
        pts3[7, :, ::11] = pts3[6, :, ::11]               # collisions
        steps = torch.randint(0, 2, (Kc, 1, M), device=dev, dtype=torch.int32)
        seg3 = torch.cumsum(steps, dim=0).to(torch.int32)
        segp3 = torch.cat([seg3[:1], seg3[:-1]], dim=0)
        inf = (pts3 == 0).all(dim=1)                       # (K, M)
        restart = (seg3 != segp3)[:, 0]
        restart[0] = True
        madds = _scan_adds(inf, restart)
        for tails in (False, True):
            log(f"K5 bucket_scan_rows {group} (32, {2 * rows}, 2048) "
                f"tails_only={tails}")
            record("bucket_scan_rows",
                   lambda: K.bucket_scan_rows(pts3, seg3, segp3, group, tails),
                   lambda: K.bucket_scan_rows_plain(pts3, seg3, segp3, group,
                                                    tails),
                   lambda got: (_nbytes(pts3, seg3, segp3, got),
                                _fq_ops(group, 11 * madds)), plain_reps=1)

    n7 = 1 << 15
    for group in ("g1", "g2"):
        P = rand_points(group, n7)
        seg = torch.cumsum(torch.randint(0, 2, (n7,), device=dev), 0).to(
            torch.int32)
        inf = _zero_coord(P[2]).reshape(-1, 32).t()          # (K, M)
        for s in (None, seg):
            restart = torch.zeros_like(inf)
            restart[0] = True
            if s is not None:
                sk_ = s.reshape(-1, 32).t()
                restart[1:] = sk_[1:] != sk_[:-1]
            adds = _scan_adds(inf, restart)
            log(f"K7 jac_scan {group} (2^15, K = 32, seg={s is not None})")
            record("jac_scan", lambda: K.jac_scan(P, 32, s),
                   lambda: K.jac_scan_plain(P, 32, s),
                   lambda got: (_nbytes(P, s, got),
                                _fq_ops(group, 16 * adds)), plain_reps=1)
        adds = _wsum_adds(inf.flip(0))
        log(f"K6 weighted_chunk_sums {group} (2^15, K = 32)")
        record("weighted_chunk_sums", lambda: K.weighted_chunk_sums(P, 32),
               lambda: K.weighted_chunk_sums_plain(P, 32),
               lambda got: (_nbytes(P, got), _fq_ops(group, 16 * adds)),
               plain_reps=1)
    return results


# ---------------------------------------------------------------------------
# Phase 3: the frozen small-circuit vectors
# ---------------------------------------------------------------------------

def small_circuit(dev):
    from zukelang_tpu_torch import vectors
    vec = vectors.load()
    res = vectors.prove_all(vec, dev)
    if set(res) != set(vec.proofs):
        raise AssertionError(f"x^3+x+3: proved {sorted(res)}, the file "
                             f"holds {sorted(vec.proofs)}")
    for name, (got, ok) in res.items():
        if got != vec.proofs[name]:
            raise AssertionError(f"x^3+x+3: {name} proof differs from the "
                                 "golden bytes")
        if not ok:
            raise AssertionError(f"x^3+x+3: {name} proof does not verify")
        log(f"  {name}: proof bytes equal to the golden ones, verified")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the paths, each from zeroed launch counts
# ---------------------------------------------------------------------------

def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _check_launches(path: str, counts: dict, keygen_madds: int) -> None:
    log(f"launch counts over the {path} run: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"{path} never launched: {missing}")
    if keygen_madds <= 0:
        raise AssertionError(f"{path}: K3 did not launch in keygen")


def groth16_path(dev, log_constraints: int):
    import torch
    from zukelang_tpu_torch import bench_lib
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.protocols import groth16_device as gd
    from zukelang_tpu_torch.rng import Gen

    t0 = time.time()
    inst = bench_lib.make_synthetic_r1cs(
        log_constraints, seed=1,
        pad_log=bench_lib.canon_pad_log(log_constraints))
    fc = inst.fc
    log(f"build_r1cs_s {time.time() - t0:.3f}  (domain 2^{fc.logn})")

    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    t0 = time.time()
    crs, vkey = gd.keygen_device(fc, mids=list(inst.mids_cols),
                                 ios=list(inst.ios_cols),
                                 rng=Gen(b"bench-keygen"), device=dev)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    keygen_madds = K.LAUNCHES["point_madd"]
    wm = inst.pack_witness(dev)
    t0 = time.time()
    proof = gd.prove_device(crs, fc, wm, Gen(b"bench-prove"))
    prove_first_s = time.time() - t0
    times = []
    for i in range(3):
        before = dict(K.LAUNCHES)
        t0 = time.time()
        proof = gd.prove_device(crs, fc, wm, Gen(b"bench-prove-%d" % i))
        times.append(time.time() - t0)
    per_prove = _diff(K.LAUNCHES, before)
    t0 = time.time()
    public = {int(col): Fr(inst.witness[col]) for col in inst.ios_cols}
    ok = gd.verify(public, vkey, proof)
    verify_s = time.time() - t0
    counts = dict(K.LAUNCHES)
    prove_s = min(times)
    n = 1 << log_constraints
    msm_terms = 4 * n + len(inst.mids_cols) + 3 * n
    log(f"keygen_s {keygen_s:.3f}  (K3 launches in keygen: {keygen_madds})")
    log(f"prove_first_s {prove_first_s:.3f}")
    log(f"prove_s {prove_s:.4f}  (warm runs {[round(t, 4) for t in times]})")
    log(f"verify_s {verify_s:.3f}  verified {ok}")
    log(f"msm_mterms_per_s {msm_terms / prove_s / 1e6:.3f}  "
        f"(G1-equivalent terms per prove: {msm_terms})")
    log(f"launches per prove: {per_prove}")
    if not ok:
        raise AssertionError("groth16: proof does not verify")
    _check_launches("groth16", counts, keygen_madds)
    return counts, per_prove


def pinocchio_path(dev, log_constraints: int):
    import torch
    from zukelang_tpu_torch import bench_lib
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.protocols import pinocchio_device as pd
    from zukelang_tpu_torch.rng import Gen

    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    run = bench_lib.run_pinocchio(log_constraints, seed=1, repeats=3,
                                  zk=True, device=dev)
    res = run.record()
    after_zk = dict(K.LAUNCHES)        # keygen + ZK proves + verify
    args = (run.pkey, run.inst.fc, run.witness)
    t0 = time.time()
    proof = pd.prove_device(*args, Gen(b"bench-pin-nonzk"), zk=False)
    nonzk_s = time.time() - t0
    nonzk_per_prove = _diff(K.LAUNCHES, after_zk)
    ok = pd.verify(run.public, run.vkey, proof)
    before = dict(K.LAUNCHES)
    pd.prove_device(*args, Gen(b"bench-pin-count"), zk=True)
    per_prove = _diff(K.LAUNCHES, before)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    keygen_madds = run.keygen_launches["point_madd"]
    log(f"build_r1cs_s {run.build_r1cs_s:.3f}  (domain 2^{res['domain_log']}, "
        f"{len(run.pkey.v_all_tail)} all-variable tail points)")
    log(f"keygen_s {res['keygen_s']:.3f}  (K3 launches in keygen: "
        f"{keygen_madds})")
    log(f"prove_first_s {res['prove_first_s']:.3f}  (ZK)")
    log(f"prove_s {res['prove_s']:.4f}  (ZK; warm runs "
        f"{[round(t, 4) for t in run.warm_s]})")
    log(f"verify_s {res['verify_s']:.3f}  verified {res['verified']}")
    log(f"nonzk prove_s {nonzk_s:.4f}  verified {ok}")
    log(f"msm_mops_per_s {res['msm_mops_per_s']:.3f}  (G1-equivalent terms "
        f"per ZK prove: {res['msm_terms_per_prove']})")
    log(f"launches per ZK prove: {per_prove}")
    log(f"launches per NonZK prove: {nonzk_per_prove}")
    if not ok:
        raise AssertionError("pinocchio: NonZK proof does not verify")
    _check_launches("pinocchio", counts, keygen_madds)
    return counts, per_prove


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zukelang_tpu_torch import build, native
    from zukelang_tpu_torch.ops import kernels as K

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(build.library), pool.submit(native.library)]
        for b in builds:
            b.result()
    log(f"build_s {time.time() - t0:.2f}: kernels (nvcc) "
        f"{build.build_seconds}, native pairing (c++) {native.build_seconds}")

    log("phase 2: kernels against plain versions")
    checks = kernel_checks(dev, random.Random(2024))
    log("phase 3: x^3+x+3 vectors (Groth16, Pinocchio NonZK and ZK)")
    small_circuit(dev)
    log(f"phase 4: groth16 at 2^{LOG_CONSTRAINTS}")
    paths = {f"groth16_2^{LOG_CONSTRAINTS}": groth16_path(dev, LOG_CONSTRAINTS)}
    log(f"phase 5: pinocchio at 2^{PIN_LOG_CONSTRAINTS}")
    paths[f"pinocchio_2^{PIN_LOG_CONSTRAINTS}"] = pinocchio_path(
        dev, PIN_LOG_CONSTRAINTS)

    kernels = []
    for name in K.KERNELS:
        source, replaces = REPLACES[name]
        rows = checks[name]
        last = rows[-1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c, _ in paths.values()),
            "launches_by_path": {p: c[name] for p, (c, _) in paths.items()},
            "launches_per_prove": {p: pp[name]
                                   for p, (_, pp) in paths.items()},
            "max_abs_err": max(r["err"] for r in rows),
            "ms": last["ms"], "plain_ms": last["plain_ms"],
            "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
            "library_ms": last["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
