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
     after a warm-up, beside each kernel's bound (bytes or operations).
     K2's add at 2^12 (P == Q, P == -Q and infinity lanes), as a carry
     add and as the small scan of 80 (G1) / 40 (G2) of those points; K2's
     chained doubling at 2^12 with count 1 and at the window combine's 80
     (G1) and 20 (G2) points with counts 13 w; K3 at 2^12 and 16 lanes,
     and K3's chain on 16 lanes of 16 windows with a doubling lane; K5 on
     a small row table with and without bucket tails, a forced collision
     flagged;
     the NTT kernel's four forms at 2^1, 2^2, 2^10, 2^11, 2^12 and 2^16
     (a batch of 3) and 2^20 (one vector); K8 at 2^16 (G1, G2) at g = 1
     and at the wrapper's g, with a forced collision in every 11th chunk
     flagged at both;
  3. the frozen x^3 + x + 3 vectors (zukelang_tpu_torch/testdata): keygen,
     prove and verify of Groth16, Pinocchio NonZK and Pinocchio ZK under
     the injected scalars; the proof bytes must equal the golden ones;
  4. Groth16 at 2^16: keygen, prove (one cold, three warm) and verify on
     make_synthetic_r1cs(16, seed=1), every kernel launch counted, K3's
     chain held against its plain version on the keygen's small batch;
     then one more prove whose witness reduction, K4, K5, K6, K7 and K2
     inputs are kept, and each of those calls against its plain version:
     the fused witness reduction (the NTT kernel, a, b and h), K4 on the
     G1 (80, 2^16) and G2 (20, 2^16) digit blocks beside the stable
     `torch.sort`, K5 on both groups' whole blocks, K6 on the three levels
     of the weighted reduction in each group, K7 on every carry scan, the
     doubling on the window combine and the reduction's doublings in each
     group, K2's add on each Hillis-Steele tail and window combine (the
     small scan), each carry add and each add of the weighted reduction;
     and the launches of one witness reduction (at most 10);
  5. Pinocchio at the JAX bench's size: make_synthetic_r1cs(14, seed=1)
     on its 2^16 domain (`bench_lib.run_pinocchio`): keygen, ZK proves
     (one cold, three warm), verify; then one NonZK prove and its verify,
     and one more ZK prove, every kernel launch counted;
  6. the MSM window profile at 2^18, c = 14, G1 (`profile_msm`): every
     stage, then `window_program` over all 19 windows of the signed
     digits, combined on the host (sum of 2^(cw) W_w) and held equal to
     `msm_staged` on the same bases and scalars (the K8 route against the
     K5/K6 route); at 2^10 both are also held equal to golden `G1.dot`;
     `profile_msm` holds its K3 phase 1 and its log-depth carry scan
     against the K8 and K7 route; then every kernel the window program
     launches is checked against its plain version on the path's own
     inputs: K4 on the 2^18 window (beside the stable `torch.sort`), K8
     at g = 1 and at the wrapper's g,
     K3 at one step of the 8192 chunk lanes and K3's chain over the whole
     chunked phase 1, K7 over the 8192 chunk tails
     (K = 32, segmented) and over the 8256 padded buckets (K = 64), and K2
     at those two widths;
  7. the looped-product probe at 2^20 Fq (`probe_looped`): its output
     equal to K1's, both timed, the nvcc and ptxas figures of both
     sources and their kernels' SASS instructions (the looped kernel's
     fewer than K1's, or it raises); then the looped kernel against its
     plain version there.
Phases 4 and 5 also print the launches of one prove.
Each path of phases 4 to 7 starts from zeroed counts; every kernel of
the path must have launched in it; K3 once a small fixed-base batch of
both keygens (once in all for Groth16) and once a chunked phase 1; K2's
add at most MAX_ADD_LAUNCHES times a prove.  Then one JSON
line with the kernel summaries, the card line, and the last line
{"ok": true, "device": {...}}.

Without CUDA it stops at once with a non-zero exit and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.modules["jax"] = None           # any JAX import below fails loudly
sys.modules["zukelang_tpu"] = None  # and so does any import of the JAX package

LOG_CONSTRAINTS = 16        # the bench headline groth16_prove_2^16
PIN_LOG_CONSTRAINTS = 14    # the JAX bench's pinocchio_prove_2^14
WINDOW_LOG, WINDOW_C = 18, 14   # the JAX MSM profilers' window
GOLDEN_LOG = 10             # the window route against golden G1.dot
PROBE_LOG = 20              # the JAX looped-kernel probe's size

# kernel -> (its CUDA source, the Pallas entry point it replaces)
REPLACES = {
    "mont_mul": ("zukelang_tpu_torch/csrc/mont_mul.cu",
                 "zukelang_tpu/ops/pallas_kernels.py:201"),
    "point_add": ("zukelang_tpu_torch/csrc/point_add.cu",
                  "zukelang_tpu/ops/pallas_kernels.py:346"),
    "point_double": ("zukelang_tpu_torch/csrc/point_ops.cu",
                     "zukelang_tpu/ops/pallas_kernels.py:359"),
    "point_madd": ("zukelang_tpu_torch/csrc/point_madd.cu",
                   "zukelang_tpu/ops/pallas_kernels.py:663"),
    "digit_sort": ("zukelang_tpu_torch/csrc/digit_sort.cu",
                   "zukelang_tpu/ops/pallas_kernels.py:1173"),
    "bucket_scan_rows": ("zukelang_tpu_torch/csrc/bucket_scan.cu",
                         "zukelang_tpu/ops/pallas_kernels.py:1296"),
    "jac_scan": ("zukelang_tpu_torch/csrc/jac_scan.cu",
                 "zukelang_tpu/ops/pallas_kernels.py:986"),
    "weighted_chunk_sums": ("zukelang_tpu_torch/csrc/weighted_sums.cu",
                            "zukelang_tpu/ops/pallas_kernels.py:1455"),
    "bucket_scan": ("zukelang_tpu_torch/csrc/bucket_scan.cu",
                    "zukelang_tpu/ops/pallas_kernels.py:807"),
    "mont_mul_looped": ("zukelang_tpu_torch/csrc/mont_mul_looped.cu",
                        "scripts/probe_looped_kernel.py:29"),
    # K1 as the NTT's device function, in place of the XLA loop of gather
    # butterflies (zukelang_tpu/ops/ntt.py:85) that calls K1 a stage
    "ntt": ("zukelang_tpu_torch/csrc/ntt.cu",
            "zukelang_tpu/ops/pallas_kernels.py:201"),
}

# the kernels each path must launch
PROVE_KERNELS = ("mont_mul", "point_add", "point_double", "point_madd",
                 "digit_sort", "bucket_scan_rows", "jac_scan",
                 "weighted_chunk_sums", "ntt")
NTT_SHAPES = ((1, 3), (2, 3), (10, 3), (11, 3), (12, 3), (16, 3), (20, 1))
MAX_WITNESS_REDUCTION_LAUNCHES = 10
# K2 add launches a prove: a Hillis-Steele tail, a combine, the carry
# adds and the two weighted-reduction adds of each group's batch
MAX_ADD_LAUNCHES = {"groth16": 15, "pinocchio": 15}
WINDOW_KERNELS = ("digit_sort", "bucket_scan", "jac_scan", "point_add",
                  "point_madd", "mont_mul")
PROBE_KERNELS = ("mont_mul_looped", "mont_mul")

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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(a, b) -> int:
    """Largest |difference| of the uint32 words (or ints) of two results."""
    import torch
    if a is None or b is None:
        if (a is None) != (b is None):
            raise AssertionError("kernel and plain differ in what they return")
        return 0
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


def _wsum_work(group, P, K):
    """work(got) of a K6 call: 16 coordinate products per full add of the
    one-thread reversed scan, the fewest adds that give s and w."""
    inf = _zero_coord(P[2]).reshape(-1, K).t()              # (K, M)
    adds = _wsum_adds(inf.flip(0))
    return lambda got: (_nbytes(P, got), _fq_ops(group, 16 * adds))


# kernel name -> rows of its checks: err, ms, plain_ms, bound, library_ms
RESULTS = {}


def record(name, kern, plain, work, reps=20, plain_reps=2, library=None):
    """Hold a kernel call against its plain version, time both (and the
    library call; `timing.time_ms`, mean of `reps` after a warm-up; the
    plain version with plain_reps=0 by the host clock around the call that
    was checked), and keep the row.  work(got) -> (bytes, operations)."""
    import torch
    from zukelang_tpu_torch.timing import time_ms
    dev = torch.device("cuda:0")
    got = kern()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    first_plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(got, want)
    ms = time_ms(kern, dev, reps, "mean")[0]
    plain_ms = (time_ms(plain, dev, plain_reps, "mean")[0] if plain_reps
                else first_plain_ms)
    lib_ms = (time_ms(library, dev, reps, "mean")[0]
              if library is not None else None)
    bound_ms, bound_by = _bound(*work(got))
    RESULTS.setdefault(name, []).append(dict(
        err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms))
    log(f"  {name}: max_abs_err {err}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})"
        + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""))
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with plain")


def _add_work(group, P, Q):
    """work(got) of a K2 add (add-2007-bl): 16 coordinate products per
    lane with both operands finite, 15 where they are equal (8 + the
    doubling's 7)."""
    import torch
    finite = ~_zero_coord(P[2]) & ~_zero_coord(Q[2])
    n = P[0].shape[-1]
    equal = torch.stack([(a == b).reshape(-1, n).all(0)
                         for a, b in zip(P, Q)]).all(0)
    products = int(16 * (finite & ~equal).sum() + 15 * (finite & equal).sum())
    return lambda got: (_nbytes(P, Q, got), _fq_ops(group, products))


def _carry_work(group, P, car, idx):
    """work(got) of a K2 carry add: the add's products on the gathered
    second operand (infinity where idx < 0); bytes: p, the carries and
    the indices read once, the sums written once."""
    import torch
    from zukelang_tpu_torch.ops import kernels as K
    take = idx >= 0
    j = idx.clamp(min=0).long()
    Q = tuple(K.select_lanes(take, c[..., j], torch.zeros_like(x))
              for c, x in zip(car, P))
    work = _add_work(group, P, Q)
    return lambda got: (_nbytes(P, car, idx, got), work(got)[1])


def _seg_scan_small_work(group, P, seg):
    """work(got) of a K2 small scan: 16 coordinate products per add a
    segmented prefix sum needs (both operands finite), counted on the
    sequential scan as K7's bound counts it, not on the extra adds of
    the Hillis-Steele rounds."""
    import torch
    inf = _zero_coord(P[2])[:, None]                          # (n, 1)
    restart = (seg[1:] != seg[:-1])[:, None]
    restart = torch.cat([torch.ones_like(restart[:1]), restart])
    adds = _scan_adds(inf, restart)
    return lambda got: (_nbytes(P, seg, got), _fq_ops(group, 16 * adds))


def _chain_work(group, table, steps, digits, c, seg):
    """work(got) of a K3 chain: 11 coordinate products per step with both
    operands finite and no restart; bytes: the table entries its steps
    gather, the digits or segment ids, read once, the sums written once."""
    import torch
    from zukelang_tpu_torch.ops import kernels as K
    cols = K._chain_columns(table[0].shape[-1], steps, digits, c,
                            table[0].device)                  # (steps, n)
    inf = _zero_coord(table[0])[cols] & _zero_coord(table[1])[cols]
    restart = torch.zeros_like(inf)
    restart[0] = True
    if seg is not None:
        restart[1:] = seg[cols[1:]] != seg[cols[1:] - 1]
    madds = _scan_adds(inf, restart)
    entry = 2 * table[0].numel() // table[0].shape[-1] * 4
    return lambda got: (cols.numel() * entry + _nbytes(digits, seg, got),
                        _fq_ops(group, 11 * madds))


def _madd_work(group, P, Qa):
    """work(got) of a K3 madd: 11 coordinate products per lane with both
    operands finite."""
    q_inf = _zero_coord(Qa[0]) & _zero_coord(Qa[1])
    lanes = int((~_zero_coord(P[2]) & ~q_inf).sum())
    return lambda got: (_nbytes(P, Qa, got), _fq_ops(group, 11 * lanes))


def _jac_scan_work(group, P, K, seg):
    """work(got) of a K7 scan: 16 coordinate products per full add."""
    import torch
    inf = _zero_coord(P[2]).reshape(-1, K).t()            # (K, M)
    restart = torch.zeros_like(inf)
    restart[0] = True
    if seg is not None:
        sk = seg.reshape(-1, K).t()
        restart[1:] = sk[1:] != sk[:-1]
    adds = _scan_adds(inf, restart)
    return lambda got: (_nbytes(P, seg, got), _fq_ops(group, 16 * adds))


def _double_work(group, P, counts):
    """work(got) of a chained doubling: 7 coordinate products per
    doubling the counts ask for."""
    total = (int(counts.clamp(min=0).sum()) if hasattr(counts, "sum")
             else max(0, int(counts)) * P[0].shape[-1])
    return lambda got: (_nbytes(P, got, counts if hasattr(counts, "sum")
                                else None), _fq_ops(group, 7 * total))


def _k5_work(group, rows, idx, seg, K):
    """work(got) of a K5 call: 11 coordinate products per continuing
    step with both operands finite; bytes: the row table, indices and
    segment ids read once, the outputs written once."""
    inf = (rows[idx.reshape(-1).long()] == 0).all(dim=1).reshape(-1, K).t()
    sk = seg.reshape(-1, K).t()
    restart = sk != sk.roll(1, 0)
    restart[0] = True
    madds = _scan_adds(inf, restart)
    return lambda got: (_nbytes(rows, idx, seg, got), _fq_ops(group,
                                                              11 * madds))


def _k8_work(points, seg, K, group):
    """work(got) of a K8 call: 11 coordinate products per continuing step
    with both operands finite (the sequential scan's, at any g)."""
    inf = (_zero_coord(points[0]) & _zero_coord(points[1])).reshape(-1, K).t()
    sk = seg.reshape(-1, K).t()
    restart = sk != sk.roll(1, 0)
    restart[0] = True
    madds = _scan_adds(inf, restart)
    return lambda got: (_nbytes(points, seg, got), _fq_ops(group, 11 * madds))


def k8_at_widths(what: str, points, seg, Kc: int, group: str,
                 plain_reps: int, want_flag=None):
    """K8 at g = 1 (the sequential scan) and then at the wrapper's g
    (`bscan_group`), each held against its plain version at that g (and
    its flags against want_flag); logs the ratio of the two times."""
    from zukelang_tpu_torch.ops import kernels as K
    n = seg.shape[-1]
    chosen = K.bscan_group(n // Kc, Kc, group)
    for g in sorted({1, chosen}):
        log(f"K8 bucket_scan {what} ({group}, K = {Kc}, g = {g})")
        record("bucket_scan",
               lambda: K.bucket_scan(points, seg, Kc, group, g),
               lambda: K.bucket_scan_plain(points, seg, Kc, group, g),
               _k8_work(points, seg, Kc, group), plain_reps=plain_reps)
        flag = K.bucket_scan(points, seg, Kc, group, g)[1]
        if want_flag is not None and not bool((flag == want_flag).all()):
            raise AssertionError(f"bucket_scan g = {g}: the flags are not "
                                 "the constructed collision lanes")
    rows = RESULTS["bucket_scan"]
    if chosen != 1:
        log(f"  K8 at g = {chosen} / g = 1: {rows[-1]['ms']:.4f} / "
            f"{rows[-2]['ms']:.4f} ms = {rows[-1]['ms'] / rows[-2]['ms']:.3f}")


# per NTT form: (products a point besides the butterflies, tables read)
NTT_FORMS = {"ntt": (0, 0), "intt": (1, 0), "coset_ntt": (1, 1),
             "coset_intt": (2, 1)}


def _ntt_work(x, form: str):
    """work(got) of one batched NTT form: an Fr product a butterfly
    ((N/2) log N a vector) and the form's scalings; bytes: the input and
    the twiddles and coset powers read once, the output written once."""
    B, nl, n = x.shape
    logn = n.bit_length() - 1
    extra, tables = NTT_FORMS[form]
    products = B * ((n // 2) * logn + extra * n)
    return lambda got: (_nbytes(x, got) + 4 * nl * (n // 2 + tables * n),
                        products * PRODUCTS["Fr"])


def _witness_reduction_work(fc, args):
    """work(got) of the fused witness reduction: the gate sums' products,
    seven transforms of (N/2) log N butterflies and 10 N products of the
    scalings and the quotient; bytes: the witness, the gate rows, the
    twiddles and coset powers of both directions read once, a, b and h
    written once."""
    n = 1 << fc.logn
    gate = sum(s.idx.size for s in (fc.l, fc.r, fc.lhs))
    products = gate + 7 * (n // 2) * fc.logn + 10 * n
    return lambda got: (_nbytes(args, got) + 4 * 8 * (n + 2 * n),
                        products * PRODUCTS["Fr"])


def kernel_checks(dev, rng: random.Random):
    import torch
    from zukelang_tpu_torch.ops import field as F
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import ntt
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

    n = 1 << 16
    for spec in (FR, FQ):
        a, b = rand_field(spec, n), rand_field(spec, n)
        log(f"K1 mont_mul {spec.name} (nl, 2^16)")
        record("mont_mul", lambda: K.mont_mul(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got), n * PRODUCTS[spec.name]))
        log(f"mont_mul_looped {spec.name} (nl, 2^16)")
        record("mont_mul_looped", lambda: K.mont_mul_looped(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got), n * PRODUCTS[spec.name]))
        if not torch.equal(K.mont_mul_looped(a, b, spec),
                           K.mont_mul(a, b, spec)):
            raise AssertionError("mont_mul_looped: differs from K1")

    for logn, B in NTT_SHAPES:
        x = rand_field(FR, B << logn).reshape(FR.nl, B, 1 << logn)
        x = x.transpose(0, 1).contiguous()
        for form in NTT_FORMS:
            log(f"NTT {form} (B = {B}, 2^{logn})")
            record("ntt", lambda: getattr(ntt, form)(x),
                   lambda: getattr(ntt, form + "_plain")(x),
                   _ntt_work(x, form), plain_reps=0)

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
        log(f"K2 point_add / point_double {group} (2^12)")
        record("point_add", lambda: K.point_add(P, Q),
               lambda: K.point_add_plain(P, Q), _add_work(group, P, Q),
               plain_reps=1)
        # the carry add, P[i] + Q[idx[i]] (nothing where idx < 0), and the
        # small scan of the first 80 (G1) / 40 (G2) points in segments of 6
        car = tuple(x[..., :n2 // 8] for x in Q)
        idx = ((torch.arange(n2, device=dev) * 5) % (n2 // 8 + 3) - 3).to(
            torch.int32)
        log(f"K2 point_add_carry {group} (2^12 lanes, {n2 // 8} carries)")
        record("point_add", lambda: K.point_add_carry(P, car, idx),
               lambda: K.point_add_carry_plain(P, car, idx),
               _carry_work(group, P, car, idx), plain_reps=1)
        ns = 80 if group == "g1" else 40
        Ps = tuple(x[..., :ns].contiguous() for x in P)
        segs = (torch.arange(ns, device=dev) // 6).to(torch.int32)
        log(f"K2 seg_scan_small {group} ({ns} points, segments of 6)")
        record("point_add", lambda: K.seg_scan_small(Ps, segs),
               lambda: K.seg_scan_small_plain(Ps, segs),
               _seg_scan_small_work(group, Ps, segs), plain_reps=1)
        record("point_double", lambda: K.point_double(P),
               lambda: K.point_double_plain(P),
               lambda got: (_nbytes(P, got), _fq_ops(group, 7 * n2)),
               plain_reps=1)
        # the window combine's shape: 4 (G1) / 1 (G2) MSMs of 20 windows,
        # window w doubled 13 w times (count 0 at w = 0), infinity lanes
        nd = 80 if group == "g1" else 20
        Pd = rand_points(group, nd)
        counts = (13 * (torch.arange(nd, device=dev) % 20)).to(torch.int32)
        log(f"K2 point_double_n {group} ({nd} points, counts 13 w)")
        record("point_double", lambda: K.point_double_n(Pd, counts),
               lambda: K.point_double_n_plain(Pd, counts),
               _double_work(group, Pd, counts), plain_reps=0)

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
            log(f"K3 point_madd {group} ({nm} lanes)")
            record("point_madd", lambda: K.point_madd(Pm, Qa),
                   lambda: K.point_madd_plain(Pm, Qa),
                   _madd_work(group, Pm, Qa), plain_reps=1)
            _got, flag = K.point_madd(Pm, Qa)
            if not bool(flag[1::5].all()) or bool(flag[2::5].any()):
                raise AssertionError("point_madd: doubling flag wrong")

        # the chain at the keygen's shape: 16 lanes, 16 windows of a
        # random table of 2^4 entries each (entry 0 infinity); lane 3 adds
        # its first point again (the doubling case)
        cw, W = 4, 16
        tX, tY = rand_coord(group, W << cw), rand_coord(group, W << cw)
        tX[..., ::1 << cw], tY[..., ::1 << cw] = 0, 0
        tX[..., (1 << cw) + 5] = tX[..., 5]
        tY[..., (1 << cw) + 5] = tY[..., 5]
        dig = torch.randint(0, 1 << cw, (W, 16), device=dev).to(torch.int32)
        dig[0, 3] = dig[1, 3] = 5
        tab = (tX, tY)
        log(f"K3 point_madd_chain {group} (16 lanes, {W} windows)")
        record("point_madd", lambda: K.point_madd_chain(tab, W, dig, cw),
               lambda: K.point_madd_chain_plain(tab, W, dig, cw),
               _chain_work(group, tab, W, dig, cw, None), plain_reps=1)

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

    # K5: a table of 4096 random affine rows (row 7 the infinity), 4 block
    # rows of 2048 sorted positions (digits below 257); position 1 of each
    # row repeats position 0's point in its segment: the doubling case
    nrows, B5, n5, nb5 = 4096, 4, 2048, 257
    for group in ("g1", "g2"):
        tab = torch.cat([rand_coord(group, nrows).reshape(-1, nrows),
                         rand_coord(group, nrows).reshape(-1, nrows)]).t()
        tab = tab.contiguous()
        tab[7] = 0
        idx5 = torch.randint(0, nrows, (B5, n5), dtype=torch.int32,
                             device=dev)
        idx5[:, 1] = idx5[:, 0] = 11
        seg5 = torch.sort(torch.randint(0, nb5, (B5, n5), device=dev))[0]
        seg5 = seg5.to(torch.int32)
        seg5[:, 1] = seg5[:, 0]
        for nb in (None, nb5):
            log(f"K5 bucket_scan_rows {group} ({B5} x {n5} rows of a "
                f"{nrows}-row table, K = 32, nb = {nb})")
            record("bucket_scan_rows",
                   lambda: K.bucket_scan_rows(tab, idx5, seg5, 32, group, nb),
                   lambda: K.bucket_scan_rows_plain(tab, idx5, seg5, 32,
                                                    group, nb),
                   _k5_work(group, tab, idx5, seg5, 32), plain_reps=1)
            flag = K.bucket_scan_rows(tab, idx5, seg5, 32, group, nb)[2]
            if not bool(flag[::n5 // 32].all()):
                raise AssertionError("bucket_scan_rows: the forced collision "
                                     "is not flagged")

    n7 = 1 << 15
    for group in ("g1", "g2"):
        P = rand_points(group, n7)
        seg = torch.cumsum(torch.randint(0, 2, (n7,), device=dev), 0).to(
            torch.int32)
        for s in (None, seg):
            log(f"K7 jac_scan {group} (2^15, K = 32, seg={s is not None})")
            record("jac_scan", lambda: K.jac_scan(P, 32, s),
                   lambda: K.jac_scan_plain(P, 32, s),
                   _jac_scan_work(group, P, 32, s), plain_reps=1)
        log(f"K6 weighted_chunk_sums {group} (2^15, K = 32, "
            f"g = {K.wsum_group(n7 // 32, 32)})")
        record("weighted_chunk_sums", lambda: K.weighted_chunk_sums(P, 32),
               lambda: K.weighted_chunk_sums_plain(P, 32),
               _wsum_work(group, P, 32), plain_reps=1)

    # K8 on the flat layout: random segments, affine infinity at step 5
    # of every 13th lane, and in every 11th lane a segment that starts at
    # step 6 and repeats that point at step 7 (the doubling case)
    n8, K8 = 1 << 16, 32
    M8 = n8 // K8
    lanes = torch.arange(M8, device=dev) * K8
    want_flag = torch.zeros(M8, dtype=torch.bool, device=dev)
    want_flag[::11] = True
    for group in ("g1", "g2"):
        X8, Y8 = rand_coord(group, n8), rand_coord(group, n8)
        inf_cols, dup = lanes[::13] + 5, lanes[::11] + 6
        X8[..., inf_cols] = 0
        Y8[..., inf_cols] = 0
        X8[..., dup + 1] = X8[..., dup]
        Y8[..., dup + 1] = Y8[..., dup]
        steps = torch.randint(0, 2, (n8,), device=dev)
        steps[dup] = 1
        steps[dup + 1] = 0
        seg8 = torch.cumsum(steps, 0).to(torch.int32)
        k8_at_widths("at 2^16", (X8, Y8), seg8, K8, group, 1, want_flag)
    return RESULTS


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


def _check_launches(path: str, counts: dict, required,
                    keygen_madds: int = None, small_batches: int = None,
                    per_prove: dict = None) -> None:
    """Every kernel of the path launched; K3 once a small fixed-base
    batch of keygen (its chain); K2's add at most MAX_ADD_LAUNCHES[path]
    times a prove."""
    log(f"launch counts over the {path} run: {counts}")
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched: {missing}")
    if keygen_madds is not None and keygen_madds <= 0:
        raise AssertionError(f"{path}: K3 did not launch in keygen")
    if small_batches is not None and keygen_madds != small_batches:
        raise AssertionError(f"{path}: K3 launched {keygen_madds} times in "
                             f"keygen for {small_batches} small fixed-base "
                             "batches (one chain a batch)")
    if per_prove is not None and per_prove["point_add"] > MAX_ADD_LAUNCHES[
            path]:
        raise AssertionError(f"{path}: {per_prove['point_add']} K2 add "
                             "launches a prove, more than "
                             f"{MAX_ADD_LAUNCHES[path]}")


def groth16_path(dev, log_constraints: int):
    import torch
    from zukelang_tpu_torch import bench_lib, profile_prove
    from zukelang_tpu_torch.engine import torch_engine as te
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
    out = {}
    keygen_seen = _capture_inputs(
        lambda: out.setdefault("keys", gd.keygen_device(
            fc, mids=list(inst.mids_cols), ios=list(inst.ios_cols),
            rng=Gen(b"bench-keygen"), device=dev)),
        [(K, "point_madd_chain"), (msm, "_fixed_base_madd")])
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    crs, vkey = out["keys"]
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
    _check_launches("groth16", counts, PROVE_KERNELS, keygen_madds,
                    len(keygen_seen["_fixed_base_madd"]), per_prove)
    if keygen_madds != 1:
        raise AssertionError(f"groth16: {keygen_madds} K3 launches in keygen, "
                             "expected 1 (the io batch's chain)")
    for (tab, steps, dig, cw), _kw in keygen_seen["point_madd_chain"]:
        log(f"K3 point_madd_chain at the keygen's inputs ({dig.shape[1]} "
            f"lanes, {steps} windows of 2^{cw}, lanes a point "
            f"{K.MADD_CHAIN_LANES[K.group_of(tab[0])]})")
        record("point_madd", lambda: K.point_madd_chain(tab, steps, dig, cw),
               lambda: K.point_madd_chain_plain(tab, steps, dig, cw),
               _chain_work(K.group_of(tab[0]), tab, steps, dig, cw, None),
               plain_reps=0)
    wr = profile_prove.witness_reduction_launches(fc, wm)
    log(f"launches of one witness reduction: {wr['kernel_launches']} "
        f"kernel launches, {wr['device_events']} device events "
        f"({wr['device_ms']:.4f} device ms): {wr['by_kernel']}")
    if not 0 < wr["device_events"] <= MAX_WITNESS_REDUCTION_LAUNCHES:
        raise AssertionError(f"groth16: the witness reduction made "
                             f"{wr['device_events']} device events, more "
                             f"than {MAX_WITNESS_REDUCTION_LAUNCHES}")
    seen = _capture_inputs(
        lambda: gd.prove_device(crs, fc, wm, Gen(b"bench-capture")),
        [(K, k) for k in ("digit_sort", "weighted_chunk_sums",
                          "bucket_scan_rows", "point_double_n", "jac_scan",
                          "point_add", "point_add_carry", "seg_scan_small")]
        + [(te, "run_witness_reduction")])
    prove_path_kernel_checks(seen)
    return counts, per_prove


def _capture_inputs(run, targets):
    """Run `run()` with the functions `targets` names ((module, name)
    pairs: the kernel wrappers of `ops.kernels`, the witness reduction)
    wrapped so that their arguments are kept: -> {name: [(args, kwargs)
    of each call]}."""
    seen = {k: [] for _m, k in targets}
    orig = {k: (m, getattr(m, k)) for m, k in targets}

    def keep(name):
        def call(*args, **kwargs):
            seen[name].append((args, kwargs))
            return orig[name][1](*args, **kwargs)
        return call
    try:
        for m, k in targets:
            setattr(m, k, keep(k))
        run()
    finally:
        for k, (m, fn) in orig.items():
            setattr(m, k, fn)
    return seen


def prove_path_kernel_checks(seen):
    """The witness reduction, K4, K5, K6, K7, K2's doubling and K2's add
    against their plain versions on one Groth16 prove's own inputs: the
    fused reduction's a, b and h; the G1 and G2 digit blocks, beside the
    stable `torch.sort`; K5 on both groups' whole blocks; the three levels
    of `_wreduce_batched` in each group; every carry scan of K7; the
    window combine's chain and the reduction's doublings in each group;
    every K2 add: each Hillis-Steele tail and window combine (the small
    scan), each carry add and the weighted reduction's adds."""
    import torch
    from zukelang_tpu_torch.engine import torch_engine as te
    from zukelang_tpu_torch.ops import kernels as K
    sorts, wsums = seen["digit_sort"], seen["weighted_chunk_sums"]
    scans, dbls = seen["bucket_scan_rows"], seen["point_double_n"]
    jscans, wreds = seen["jac_scan"], seen["run_witness_reduction"]
    if (len(sorts), len(scans), len(wsums), len(dbls), len(wreds)) != (
            2, 2, 6, 6, 1):
        raise AssertionError(
            f"groth16 prove: {len(sorts)} K4, {len(scans)} K5, {len(wsums)} "
            f"K6, {len(dbls)} doubling calls and {len(wreds)} witness "
            "reductions, expected 2, 2, 6, 6 and 1")
    if {K.group_of(a[0][0]) for a, _kw in jscans} != {"g1", "g2"}:
        raise AssertionError("groth16 prove: K7 did not scan both groups")
    (fc, wm), _kw = wreds[0]
    args = (*te._side_tensors(fc.l, wm.device),
            *te._side_tensors(fc.r, wm.device),
            *te._side_tensors(fc.lhs, wm.device), wm)
    log(f"NTT kernel: the fused witness reduction at the prove's inputs "
        f"(2^{fc.logn}, {fc.n_gates} gates; a, b and h)")
    record("ntt", lambda: te.run_witness_reduction(fc, wm),
           lambda: te.witness_reduction_plain(fc.logn)(*args),
           _witness_reduction_work(fc, args), plain_reps=0)
    for (pts, kc, *rest), kw in jscans:
        sg = rest[0] if rest else kw.get("seg")
        group = K.group_of(pts[0])
        chunks = pts[0].shape[-1] // kc
        log(f"K7 jac_scan at the prove's inputs ({group}, {chunks} chunks of "
            f"{kc}, seg={sg is not None}, g = {K.jac_scan_group(chunks, kc)})")
        record("jac_scan", lambda: K.jac_scan(pts, kc, sg),
               lambda: K.jac_scan_plain(pts, kc, sg),
               _jac_scan_work(group, pts, kc, sg), plain_reps=0)
    for (keys, nb), _kw in sorts:
        log(f"K4 digit_sort at the prove's inputs ({tuple(keys.shape)}, "
            f"nb = {nb})")
        record("digit_sort", lambda: K.digit_sort(keys, nb),
               lambda: K.digit_sort_plain(keys, nb),
               lambda got: (_nbytes(keys, got), 0),
               library=lambda: torch.sort(keys, dim=-1, stable=True))
    for (rows, idx, seg, kc, group, nb), _kw in scans:
        log(f"K5 bucket_scan_rows at the prove's inputs ({group}, whole: "
            f"{tuple(idx.shape)} positions of a {rows.shape[0]}-row table, "
            f"K = {kc}, nb = {nb})")
        record("bucket_scan_rows",
               lambda: K.bucket_scan_rows(rows, idx, seg, kc, group, nb),
               lambda: K.bucket_scan_rows_plain(rows, idx, seg, kc, group, nb),
               _k5_work(group, rows, idx, seg, kc), plain_reps=0)
    for i, ((pts, kc), _kw) in enumerate(wsums):
        group = K.group_of(pts[0])
        chunks = pts[0].shape[-1] // kc
        log(f"K6 weighted_chunk_sums at the prove's inputs ({group}, level "
            f"{i % 3 + 1}: {chunks} chunks of {kc}, "
            f"g = {K.wsum_group(chunks, kc)})")
        record("weighted_chunk_sums", lambda: K.weighted_chunk_sums(pts, kc),
               lambda: K.weighted_chunk_sums_plain(pts, kc),
               _wsum_work(group, pts, kc), plain_reps=1)
    for (pts, counts), _kw in dbls:
        group = K.group_of(pts[0])
        n = pts[0].shape[-1]
        what = (f"max count {int(counts.max())}" if hasattr(counts, "max")
                else f"count {counts}")
        log(f"K2 point_double_n at the prove's inputs ({group}, {n} points, "
            f"{what})")
        record("point_double", lambda: K.point_double_n(pts, counts),
               lambda: K.point_double_n_plain(pts, counts),
               _double_work(group, pts, counts), plain_reps=0)
    adds, carries = seen["point_add"], seen["point_add_carry"]
    smalls = seen["seg_scan_small"]
    n_adds = len(adds) + len(carries) + len(smalls)
    if not carries or not smalls or n_adds > MAX_ADD_LAUNCHES["groth16"]:
        raise AssertionError(
            f"groth16 prove: {len(adds)} adds, {len(carries)} carry adds and "
            f"{len(smalls)} small scans, expected some of each and at most "
            f"{MAX_ADD_LAUNCHES['groth16']} in all")
    for (pts, sg), _kw in smalls:
        group, n = K.group_of(pts[0]), pts[0].shape[-1]
        log(f"K2 seg_scan_small at the prove's inputs ({group}, {n} points, "
            f"{int((sg[1:] != sg[:-1]).sum()) + 1} segments, lanes a point "
            f"{K.point_lanes(group, n, 'scan')})")
        record("point_add", lambda: K.seg_scan_small(pts, sg),
               lambda: K.seg_scan_small_plain(pts, sg),
               _seg_scan_small_work(group, pts, sg), plain_reps=0)
    for (pts, car, ix), _kw in carries:
        group, n = K.group_of(pts[0]), pts[0].shape[-1]
        log(f"K2 point_add_carry at the prove's inputs ({group}, {n} lanes, "
            f"{car[0].shape[-1]} carries, {int((ix >= 0).sum())} taken, "
            f"lanes a point {K.point_lanes(group, n)})")
        record("point_add", lambda: K.point_add_carry(pts, car, ix),
               lambda: K.point_add_carry_plain(pts, car, ix),
               _carry_work(group, pts, car, ix), plain_reps=0)
    for (pts, q), _kw in adds:
        group, n = K.group_of(pts[0]), pts[0].shape[-1]
        log(f"K2 point_add at the prove's inputs ({group}, {n} lanes, lanes "
            f"a point {K.point_lanes(group, n)})")
        record("point_add", lambda: K.point_add(pts, q),
               lambda: K.point_add_plain(pts, q), _add_work(group, pts, q),
               plain_reps=0)


def pinocchio_path(dev, log_constraints: int):
    import torch
    from zukelang_tpu_torch import bench_lib
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.protocols import pinocchio_device as pd
    from zukelang_tpu_torch.rng import Gen

    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    out = {}
    small = _capture_inputs(
        lambda: out.setdefault("run", bench_lib.run_pinocchio(
            log_constraints, seed=1, repeats=3, zk=True, device=dev)),
        [(msm, "_fixed_base_madd")])["_fixed_base_madd"]
    run = out["run"]
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
    _check_launches("pinocchio", counts, PROVE_KERNELS, keygen_madds,
                    len(small), per_prove)
    return counts, per_prove


# ---------------------------------------------------------------------------
# Phases 6 and 7: the window profile and the looped-product probe
# ---------------------------------------------------------------------------

def _windows_combined(points, digits, c: int):
    """`window_program` over every window, combined on the host as golden
    points: sum_w 2^(cw) W_w (Horner from the top window)."""
    from zukelang_tpu_torch.golden.curve import G1
    from zukelang_tpu_torch.ops import curve as C
    from zukelang_tpu_torch.ops import msm
    run = msm.window_program("g1", c, affine=True)
    ws = [C.unpack_g1(run(points, digits[w]))[0]
          for w in range(digits.shape[0])]
    acc = G1.zero()
    for w in reversed(ws):
        acc = acc * (1 << c) + w
    return acc


def window_path(dev, logn: int, c: int):
    import torch
    from zukelang_tpu_torch import profile_msm
    from zukelang_tpu_torch.golden.curve import G1
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm

    K.reset_counts()
    out = {}
    phase1 = _capture_inputs(
        lambda: out.setdefault("profile", profile_msm.profile(logn, c, dev,
                                                              log=log)),
        [(msm, "_madd_chunk_scan")])["_madd_chunk_scan"]
    res, st = out["profile"]
    t0 = time.time()
    combined = _windows_combined(st["points"], st["digits"], c)
    windows_s = time.time() - t0
    staged = msm.msm_staged(st["points"], st["scalars_std"], "g1", c)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    log(f"{res['n_windows']} window programs combined in {windows_s:.3f} s "
        f"(host clock, golden combine included); equal to msm_staged: "
        f"{combined == staged}")
    log(f"launches of one window program: {res['window_program_launches']}")
    log(f"K8 collision fallbacks: {msm.FALLBACKS['bucket_sums_fused']}")
    log(f"profile_msm: {json.dumps(res)}")
    if combined != staged:
        raise AssertionError("window path: the combined windows differ from "
                             "msm_staged")
    _check_launches("window profile", counts, WINDOW_KERNELS)
    if counts["point_madd"] != len(phase1):
        raise AssertionError(f"window profile: {counts['point_madd']} K3 "
                             f"launches for {len(phase1)} chunked phase 1 "
                             "runs (one chain each)")

    pts, scs, scalars, ks = profile_msm.make_inputs(GOLDEN_LOG, dev)
    digits = msm._scalars_to_signed_windows(scs, c)
    g = G1.generator()
    golden = G1.dot([g * k for k in ks], [Fr(v) for v in scalars])
    small = (_windows_combined(pts, digits, c),
             msm.msm_staged(pts, scs, "g1", c))
    log(f"2^{GOLDEN_LOG}: combined windows and msm_staged equal to golden "
        f"G1.dot: {[x == golden for x in small]}")
    if any(x != golden for x in small):
        raise AssertionError("window path: differs from golden G1.dot at "
                             f"2^{GOLDEN_LOG}")

    path_kernel_checks(st, logn, c)
    return counts, res


def path_kernel_checks(st, logn: int, c: int):
    """Every kernel of the window program against its plain version on
    the path's own inputs (`profile_msm`'s state of window 3)."""
    import torch
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm

    Kc, nb = msm.CHUNK, msm.n_buckets(c)
    absd = st["absd"]
    log(f"K4 digit_sort at the path's inputs (one window of 2^{logn}, "
        f"nb = {nb})")
    record("digit_sort", lambda: K.digit_sort(absd, nb),
           lambda: K.digit_sort_plain(absd, nb),
           lambda got: (_nbytes(absd, got), 0),
           library=lambda: torch.sort(absd, dim=-1, stable=True))

    p8, s8 = st["pts_sorted"], st["d_sorted"]
    k8_at_widths(f"at the path's inputs (2^{logn})", p8, s8, Kc, "g1", 0)

    # step t of the chunked phase 1: the scan after step t-1 plus the
    # sorted point t of every chunk lane
    t = Kc // 2
    acc = tuple(x[..., t - 1::Kc].contiguous() for x in st["ph1"])
    cur = tuple(x[..., t::Kc].contiguous() for x in p8)
    log(f"K3 point_madd at the path's inputs (step {t} of the chunked "
        f"phase 1, {acc[0].shape[-1]} lanes)")
    record("point_madd", lambda: K.point_madd(acc, cur),
           lambda: K.point_madd_plain(acc, cur),
           _madd_work("g1", acc, cur), plain_reps=1)
    lanes = p8[0].shape[-1] // Kc
    log(f"K3 point_madd_chain at the path's inputs (the chunked phase 1: "
        f"{lanes} lanes of {Kc} steps, lanes a point "
        f"{K.MADD_CHAIN_LANES['g1']})")
    record("point_madd",
           lambda: K.point_madd_chain(p8, Kc, seg=s8, keep=True),
           lambda: K.point_madd_chain_plain(p8, Kc, seg=s8, keep=True),
           _chain_work("g1", p8, Kc, None, 0, s8), plain_reps=0)

    # the carry scan of `_carry_scatter` over the K8 chunk tails, and the
    # weighted reduce's prefix scan over the reversed, padded buckets
    tails = tuple(x[..., Kc - 1::Kc].contiguous() for x in st["k8_scan"])
    last_seg = s8[Kc - 1::Kc].contiguous()
    rev = tuple(torch.flip(v, dims=(-1,)).contiguous()
                for v in msm._set_infinity(msm._pad_buckets(
                    st["buckets"], st["nb_pad"]), 0))
    for pts, k, seg, what in ((tails, Kc, last_seg, "chunk tails"),
                              (rev, 64, None, "padded buckets")):
        n = pts[0].shape[-1]
        log(f"K7 jac_scan at the path's inputs ({n} {what}, K = {k}, "
            f"seg={seg is not None})")
        record("jac_scan", lambda: K.jac_scan(pts, k, seg),
               lambda: K.jac_scan_plain(pts, k, seg),
               _jac_scan_work("g1", pts, k, seg), plain_reps=1)
        # K2 at the same width: the scan's carry add, operands of the path
        P, Q = K.jac_scan(pts, k, seg), pts
        log(f"K2 point_add at the path's width ({n} lanes)")
        record("point_add", lambda: K.point_add(P, Q),
               lambda: K.point_add_plain(P, Q), _add_work("g1", P, Q),
               plain_reps=1)


def probe_path(dev, logn: int):
    import torch
    from zukelang_tpu_torch import probe_looped
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.params import FQ

    K.reset_counts()
    res, (a, b, _out) = probe_looped.run(logn, dev, log=log)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    log(f"probe_looped: {json.dumps(res)}")
    _check_launches("looped probe", counts, PROBE_KERNELS)
    log(f"mont_mul_looped at the probe's inputs (Fq, 2^{logn})")
    record("mont_mul_looped", lambda: K.mont_mul_looped(a, b, FQ),
           lambda: K.mont_mul_plain(a, b, FQ),
           lambda got: (_nbytes(a, b, got), (1 << logn) * PRODUCTS["Fq"]),
           plain_reps=1)
    return counts, res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zukelang_tpu_torch import build, native
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.timing import card_line

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
    provers = list(paths)
    log(f"phase 6: MSM window profile at 2^{WINDOW_LOG}, c = {WINDOW_C}")
    paths[f"window_profile_2^{WINDOW_LOG}"] = window_path(
        dev, WINDOW_LOG, WINDOW_C)
    log(f"phase 7: looped-product probe at 2^{PROBE_LOG}")
    paths[f"probe_looped_2^{PROBE_LOG}"] = probe_path(dev, PROBE_LOG)

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
            "launches_per_prove": {p: paths[p][1][name] for p in provers},
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
