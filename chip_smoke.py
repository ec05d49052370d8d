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
  4. Groth16 at 2^16 through the bench entry point
     (`bench_lib.run_groth16(16, seed=1)`: keygen, one cold and three
     warm proves, verify), every kernel launch counted, K3's chain held
     against its plain version on the keygen's small batch; then one
     more prove whose witness reduction, K1, K4, K5, K6, K7 and K2
     inputs are kept, and each of those calls against its plain version:
     the fused witness reduction (the NTT kernel, a, b and h), K1's
     conversions, K4 on the
     G1 (80, 2^16) and G2 (20, 2^16) digit blocks beside the stable
     `torch.sort`, K5 on both groups' whole blocks, K6 on the three levels
     of the weighted reduction in each group, K7 on every carry scan, the
     doubling on the window combine and the reduction's doublings in each
     group, K2's add on each Hillis-Steele tail and window combine (the
     small scan), each carry add and each add of the weighted reduction;
     and the launches of one witness reduction (at most 10); the phase's
     wall time and the run as a `bench_rung` record;
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
     plain version there;
  8. Groth16 at 2^20, as phase 4 (c = 16: 16 windows of 32,769
     buckets, G1 64 and G2 16 digit rows of 2^20).  K4, the witness
     reduction and every K1 and K2 call are checked whole; a K5, K6 or K7
     call of more than SAMPLE_ABOVE_CHUNKS chunks on a sample of its
     block rows (the first, two between and the last), the whole call
     timed.  Phases 4 and 8 print keygen_s, prove_first_s, prove_s,
     verify_s, msm_mterms_per_s, the launches of one prove and the peak
     memory of keygen and of a prove.
  9. the engine seam: (a) the reference suite's 13 programs through the
     port's `run_pipeline` for Groth16, Pinocchio NonZK and ZK over a
     `TorchEngine` on the card, on the NTT domain (every proof verifies,
     the harness's Lang-vs-Code cross-check holds), and the frozen
     x^3 + x + 3 vectors through the engine protocols, byte-equal to the
     golden proofs; (b) Groth16 over a `TorchEngine` on the 2^16 bench
     circuit written out as gates (keygen, one cold and three warm
     proves, verify, injected scalars): keygen_s, prove_first_s, prove_s,
     verify_s, the launches and peak memory of a prove and the host
     seconds of the engine's packing and unpacking, beside
     `prove_device`'s prove_s on the same circuit, whose proof bytes must
     be equal; then K3's chain in keygen and the witness reduction's and
     the first G1 MSM's kernel calls (K1, K2, K4-K7) against their plain
     versions, K5, K6 and K7 above SAMPLE_ABOVE_CHUNKS chunks sampled.
     Both paths must launch every kernel of a prove (K3 once a small
     fixed-base batch) and neither K8 nor the looped probe.
 10. the rest of the single-card port: (a) the levelized witness
     evaluator (`core/witness.py`) on a synthetic program of 4,096 lanes
     x 16 levels (65,536 steps over 4,096 secret inputs and ONE; every
     kind, a quarter of the lanes dividing by zero in an untaken `if`
     branch): compile_s, eval_host_s, `eval_device` cold and three warm
     runs split into pack / levels / unpack, each equal to eval_host; K1's
     launches and seconds a run, the div level's (the Fermat inverse)
     apart; K1
     against its plain version on the div level's products (every one)
     and a mul level's; eval_host against eval_device at 32 to 4,096
     lanes (the crossover); (b) the suite's 13 programs through
     `eval_device` against `comp.code_eval_list`, 1/0 raising and the Or
     gadget's untaken division not; (c) the FFT API at 2^16:
     `polynomial_mul_fr` of two 32,768-coefficient polynomials against
     the host library's route (`native.fr_ntt`, `fr_mul_batch`), the
     `fft_fr` / `ifft_fr` round trip, the NTT kernel's calls and K1's
     against their plain versions, `fft_c` against numpy; (d)
     `bench_msm.main` at 2^18 at the auto window and at c = 14, Jacobian
     and affine bases, all equal and equal to `native.g1_msm`, then at
     2^10 against golden `G1.dot`; every kernel call of one Jacobian and
     one affine MSM at 2^18 against its plain version (K5 above
     SAMPLE_ABOVE_CHUNKS chunks on sampled block rows, K2's adds above
     SAMPLE_ABOVE_LANES lanes and K7 above SAMPLE_SCAN_CHUNKS chunks on
     four runs of lanes).  (a) and (b) must
     launch K1, (c) the NTT kernel and K1, (d) K2's add and doubling, K7,
     K6, K4 and K5; none of them K8 or the looped probe.
 11. the multi-rank slice (`parallel/`) on a world of one NCCL rank in
     this process (`launch.init_world1`): (a) Groth16 at 2^16 with phase
     4's keypair through `sharded_groth16_prove` (c = 4), a cold and
     three warm proves, its proof equal to `prove_device`'s under the
     same rng and verified, prove_s beside `prove_device`'s, one prove's
     split (witness reduction, MSMs, rest), launches by kernel,
     collectives and their bytes, and peak memory; (b) Pinocchio ZK at
     2^14 (pad 2^16) with phase 5's keypair, likewise; (c) the four-step
     NTT at 2^16 and 2^20: `sharded_ntt` and `sharded_intt` against
     `ntt` / `intt`, the host twiddle tables' build time and
     `sharded_ntt_phase_times`; (d) the dry run's c = 8 G1 MSM at 2^10
     against golden `G1.dot` (computed in a process of its own beside
     (a)-(c)), then `measure_msm_scaling(16, c=8)` and
     `measure_ntt_scaling(20)` at the phase's world of one rank: their
     rank targets (`scaling.msm_rank`, `ntt_rank`) on the phase's mesh,
     so that their launches are counted; (e) every kernel call of one
     more (a) prove, of (d)'s MSM and of one NTT of (d)'s scaling target
     against its plain version: K1, the NTT kernel's column and row
     batches, K7 (above SAMPLE_SCAN_CHUNKS chunks on four runs of
     chunks), K2's adds (above SAMPLE_ABOVE_LANES lanes on four runs of
     lanes) and its doubling.  (a) and (b) must launch K1, the NTT kernel
     and K2's add and doubling, (d) those and K7; none of them K8 or the
     looped probe.
Phases 4, 5, 8, 9 (b) and 11 (a), (b) also print the launches of one
prove.
Each path of phases 4 to 11 starts from zeroed counts; every kernel of
the path must have launched in it; K3 once a small fixed-base batch of
both keygens (once in all for Groth16) and once a chunked phase 1; K2's
add at most MAX_ADD_LAUNCHES times a prove.  Then one JSON
line with the kernel summaries (each kernel's last check on a whole
input), the card line, and the last line {"ok": true, "device": {...}}.

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
BIG_LOG_CONSTRAINTS = 20    # the JAX bench's groth16_prove_2^20
PIN_LOG_CONSTRAINTS = 14    # the JAX bench's pinocchio_prove_2^14
WINDOW_LOG, WINDOW_C = 18, 14   # the JAX MSM profilers' window
GOLDEN_LOG = 10             # the window route against golden G1.dot
PROBE_LOG = 20              # the JAX looped-kernel probe's size
ENGINE_LOG = 16             # phase 9: the bench headline over TorchEngine
# phase 10: the witness program at the bench headline's scale (65,536
# steps), the lanes of the eval_host / eval_device sweep (x 16 levels),
# the FFT's size and bench_msm's (the JAX script's default) and window
WITNESS_LANES, WITNESS_LEVELS = 4096, 16
WITNESS_SWEEP = tuple(1 << k for k in range(5, 13))
FFT_LOG = 16
MSM_BENCH_LOG, MSM_BENCH_C = 18, 14

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
# adds and the weighted-reduction adds of each group's batch.  At 2^20
# (c = 16) the carry scan over each group's chunk tails and the weighted
# reduction take one level more in each group than at 2^16.
# The engine's entry bounds the adds of its first G1 MSM (one batch: 7 on
# the H100), which phase 9 (b) captures.
MAX_ADD_LAUNCHES = {"groth16_2^16": 15, "pinocchio": 15, "groth16_2^20": 19,
                    "engine_groth16_2^16": 8}
# Above this many chunks a K5, K6 or K7 call of the 2^20 path is held
# against its plain version on a sample of its block rows
SAMPLE_ABOVE_CHUNKS = 8192
WINDOW_KERNELS = ("digit_sort", "bucket_scan", "jac_scan", "point_add",
                  "point_madd", "mont_mul")
PROBE_KERNELS = ("mont_mul_looped", "mont_mul")
# the engine paths (phase 9) run every kernel of a prove and keygen; they
# and the paths of phase 10 launch neither the window program's K8 nor
# the probe
ENGINE_PROTOCOLS = ("groth16", "pinocchio", "pinocchio_zk")
OFF_PATH_KERNELS = ("bucket_scan", "mont_mul_looped")
# the kernels each path of phase 10 must launch
SLICE_KERNELS = {
    "witness": ("mont_mul",), "fft": ("ntt", "mont_mul"),
    "bench_msm": ("point_add", "point_double", "jac_scan",
                  "weighted_chunk_sums", "digit_sort", "bucket_scan_rows")}
# tolerance of the complex FFT (complex128) against numpy's
FFT_C_ATOL = 1e-9
# injected trapdoor (alpha, beta, gamma, delta, tau) and prove scalars
# (r, s) of phase 9 (b), shared by the engine and the device Groth16
ENGINE_KEY = tuple(range(1000, 1005))
ENGINE_PROVE = (77, 88)
# phase 11: the sharded paths on a world of one NCCL rank: the sharded
# proves' window (the JAX default), the four-step NTT's sizes, and the
# dry run's c = 8 MSM at 2^GOLDEN_LOG
SHARDED_C = 4
SHARDED_NTT_LOGS = (16, 20)
DRYRUN_C = 8
SCALING_MSM_LOG, SCALING_NTT_LOG = 16, 20
# the kernels the sharded proves must launch, and (d): the c = 8 MSM and
# the scaling harness's rank targets
SHARDED_KERNELS = ("mont_mul", "ntt", "point_add", "point_double")
SHARDED_MSM_KERNELS = SHARDED_KERNELS + ("jac_scan",)
# Above these a K2 add (lanes) or a K7 scan (chunks) of an MSM checked
# call by call (phases 10 (d) and 11) is held against its plain version
# on four runs of a quarter as many lanes or chunks
SAMPLE_ABOVE_LANES = 1 << 15
SAMPLE_SCAN_CHUNKS = 32

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
# path -> the bench run of phases 4 and 5 (keypair, instance, witness),
# which phase 11 proves with again
RUNS = {}


def record(name, kern, plain, work, reps=20, plain_reps=2, library=None,
           echo=True):
    """Hold a kernel call against its plain version, time both (and the
    library call; `timing.time_ms`, mean of `reps` after a warm-up; the
    plain version with plain_reps=0 by the host clock around the call that
    was checked), and keep the row (logged unless `echo` is False).
    work(got) -> (bytes, operations)."""
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
    if echo or err != 0:
        log(f"  {name}: max_abs_err {err}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})"
            + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""))
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with plain")


def record_sampled(name, kern, plain, pick, work, what, reps=20, echo=True):
    """Hold the whole kernel call's output at the sampled columns
    (`pick(got)`) against the plain version on the sample (`plain`), where
    the plain version on the whole input costs too much.  `ms` and the
    bound are the whole call's, `plain_ms` the plain version's on the
    sample (once, by the host clock)."""
    import torch
    from zukelang_tpu_torch.timing import time_ms
    dev = torch.device("cuda:0")
    got = kern()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(pick(got), want)
    ms = time_ms(kern, dev, reps, "mean")[0]
    bound_ms, bound_by = _bound(*work(got))
    RESULTS.setdefault(name, []).append(dict(
        err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, sample=what))
    if echo or err != 0:
        log(f"  {name}: max_abs_err {err} on {what}  kernel {ms:.4f} ms "
            f"(whole call)  plain {plain_ms:.4f} ms (on the sample)  bound "
            f"{bound_ms:.4f} ms ({bound_by}, whole call)")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with plain on {what}")


def _rows_sample(rows: int):
    """Block rows held against the plain version where all of them cost
    too much: the first, two between and the last."""
    return sorted({0, rows // 3, 2 * rows // 3, rows - 1})


def _chunk_sample(M: int, K: int, rows: int, device):
    """(chunks, columns, what) of the sampled block rows of M chunks of K
    points laid out row after row, or None to check the call whole."""
    import torch
    if M <= SAMPLE_ABOVE_CHUNKS or M % rows:
        return None
    per, S = M // rows, _rows_sample(rows)
    rs = torch.tensor(S, device=device)
    chunks = (rs[:, None] * per + torch.arange(per, device=device)).reshape(-1)
    cols = (chunks[:, None] * K + torch.arange(K, device=device)).reshape(-1)
    return chunks, cols, f"block rows {S} of {rows} ({per} chunks each)"


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
    inf = (rows == 0).all(dim=1)[idx.reshape(-1).long()].reshape(-1, K).t()
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


def _prove_targets():
    """What `_capture_inputs` keeps of a prove: the kernel wrappers a
    prove calls and the witness reduction."""
    from zukelang_tpu_torch.engine import torch_engine as te
    from zukelang_tpu_torch.ops import kernels as K
    return ([(K, k) for k in ("digit_sort", "weighted_chunk_sums",
                              "bucket_scan_rows", "point_double_n",
                              "jac_scan", "point_add", "point_add_carry",
                              "seg_scan_small", "mont_mul")]
            + [(te, "run_witness_reduction")])


def _capture_prove(crs, fc, wm):
    """One more Groth16 prove with the inputs of its kernel calls kept."""
    from zukelang_tpu_torch.protocols import groth16_device as gd
    from zukelang_tpu_torch.rng import Gen
    return _capture_inputs(
        lambda: gd.prove_device(crs, fc, wm, Gen(b"bench-capture")),
        _prove_targets())


def groth16_path(dev, log_constraints: int, sample: bool = False):
    """Phases 4 and 8: Groth16 through `bench_lib.run_groth16` (keygen, one
    cold and three warm proves, verify), every launch counted, K3's chain
    on the keygen's small batch; then one more prove's kernel calls
    against their plain versions (`prove_path_kernel_checks`)."""
    import torch
    from zukelang_tpu_torch import bench_lib, bench_rung, profile_prove
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm

    t_phase = time.time()
    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    out = {}
    keygen_seen = _capture_inputs(
        lambda: out.setdefault("run", bench_lib.run_groth16(
            log_constraints, seed=1, repeats=3, device=dev)),
        [(K, "point_madd_chain"), (msm, "_fixed_base_madd")])
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    run = out["run"]
    res = run.record()
    path = f"groth16_2^{log_constraints}"
    keygen_madds = run.keygen_launches["point_madd"]
    log(f"build_r1cs_s {run.build_r1cs_s:.3f}  (domain 2^{res['domain_log']})")
    log(f"keygen_s {run.keygen_s:.3f}  (K3 launches in keygen: "
        f"{keygen_madds}; peak memory {run.keygen_peak_mb} MB)")
    log(f"prove_first_s {run.prove_first_s:.3f}")
    log(f"prove_s {res['prove_s']:.4f}  (warm runs "
        f"{[round(t, 4) for t in run.warm_s]}; peak memory of a prove "
        f"{run.prove_peak_mb} MB)")
    log(f"verify_s {run.verify_s:.3f}  verified {run.verified}")
    log(f"msm_mterms_per_s {res['msm_mops_per_s']:.3f}  (G1-equivalent "
        f"terms per prove: {res['msm_terms_per_prove']})")
    log(f"launches per prove: {run.prove_launches}")
    log(f"launches in keygen: {run.keygen_launches}")
    t0 = time.time()
    run.inst.pack_witness(dev)
    torch.cuda.synchronize()
    log(f"pack_witness_s {time.time() - t0:.3f}  (host packing of "
        f"{len(run.inst.witness)} witness values and the copy to the card)")
    _check_launches(path, counts, PROVE_KERNELS, keygen_madds,
                    len(keygen_seen["_fixed_base_madd"]), run.prove_launches)
    if keygen_madds != 1:
        raise AssertionError(f"{path}: {keygen_madds} K3 launches in keygen, "
                             "expected 1 (the io batch's chain)")
    for (tab, steps, dig, cw), _kw in keygen_seen["point_madd_chain"]:
        log(f"K3 point_madd_chain at the keygen's inputs ({dig.shape[1]} "
            f"lanes, {steps} windows of 2^{cw}, lanes a point "
            f"{K.MADD_CHAIN_LANES[K.group_of(tab[0])]})")
        record("point_madd", lambda: K.point_madd_chain(tab, steps, dig, cw),
               lambda: K.point_madd_chain_plain(tab, steps, dig, cw),
               _chain_work(K.group_of(tab[0]), tab, steps, dig, cw, None),
               plain_reps=0)
    # the launches are counted on the host: at 2^20 the profiler dropped
    # some or all of the reduction's device records (5 of 6, then 0 of 6,
    # in two runs on the H100)
    wr = profile_prove.witness_reduction_launches(run.inst.fc, run.witness)
    log(f"launches of one witness reduction: {wr['kernel_launches']} "
        f"kernel launches, {wr['device_events']} device events recorded "
        f"({wr['device_ms']:.4f} device ms): {wr['by_kernel']}")
    if not (0 < wr["kernel_launches"] <= MAX_WITNESS_REDUCTION_LAUNCHES
            and wr["device_events"] <= MAX_WITNESS_REDUCTION_LAUNCHES):
        raise AssertionError(
            f"{path}: the witness reduction made {wr['kernel_launches']} "
            f"kernel launches and {wr['device_events']} device events, "
            f"more than {MAX_WITNESS_REDUCTION_LAUNCHES}")
    prove_path_kernel_checks(_capture_prove(run.crs, run.inst.fc,
                                            run.witness), path, sample)
    rec = bench_rung.rung_record(f"groth16_prove_2^{log_constraints}",
                                 log_constraints, res, time.time() - t_phase,
                                 dev)
    log(f"phase wall {time.time() - t_phase:.1f} s")
    log(json.dumps(rec))
    RUNS[path] = run
    return counts, run.prove_launches


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


def _wreduce_levels(nb: int) -> int:
    """K6 launches a group of `msm._wreduce_batched` over nb buckets."""
    from zukelang_tpu_torch.ops import msm
    K = msm.CHUNK
    per, levels = -(-nb // K) * K, 1
    while per // K > 1:
        per, levels = -(-(per // K) // K) * K, levels + 1
    return levels


def _check_captured_calls(seen, path: str, n_batches: int, groups) -> None:
    """The calls `_capture_inputs` kept of n_batches MSM batches (one a
    group) and one witness reduction: a K4 and a K5 call a batch, a K6
    call and a doubling call a level of the weighted reduction (the last
    doubling is the combine's), K7 on each of `groups`, some carry adds
    and small scans, and at most MAX_ADD_LAUNCHES[path] K2 adds."""
    from zukelang_tpu_torch.ops import kernels as K
    sorts, wsums = seen["digit_sort"], seen["weighted_chunk_sums"]
    scans, dbls = seen["bucket_scan_rows"], seen["point_double_n"]
    jscans, wreds = seen["jac_scan"], seen["run_witness_reduction"]
    levels = _wreduce_levels(sorts[0][0][1]) if sorts else 0
    want = (n_batches, n_batches, n_batches * levels, n_batches * levels, 1)
    if (len(sorts), len(scans), len(wsums), len(dbls), len(wreds)) != want:
        raise AssertionError(
            f"{path}: {len(sorts)} K4, {len(scans)} K5, {len(wsums)} "
            f"K6, {len(dbls)} doubling calls and {len(wreds)} witness "
            f"reductions, expected {want}")
    if {K.group_of(a[0][0]) for a, _kw in jscans} != set(groups):
        raise AssertionError(f"{path}: K7 did not scan {sorted(groups)}")
    adds, carries = seen["point_add"], seen["point_add_carry"]
    smalls = seen["seg_scan_small"]
    n_adds = len(adds) + len(carries) + len(smalls)
    if not carries or not smalls or n_adds > MAX_ADD_LAUNCHES[path]:
        raise AssertionError(
            f"{path}: {len(adds)} adds, {len(carries)} carry adds and "
            f"{len(smalls)} small scans, expected some of each and at most "
            f"{MAX_ADD_LAUNCHES[path]} in all")


def prove_path_kernel_checks(seen, path: str, sample: bool = False,
                             n_batches: int = 2, groups=("g1", "g2")):
    """The witness reduction, K1, K4, K5, K6, K7, K2's doubling and K2's
    add against their plain versions on one Groth16 prove's own inputs
    (n_batches MSM batches over `groups`: the device prove's G1 and G2
    batches, or the engine's witness reduction and first G1 MSM):
    the fused reduction's a, b and h; K1's conversions; the G1 and G2
    digit blocks, beside the stable `torch.sort`; K5 on both groups'
    blocks; every level of `_wreduce_batched` in each group; every carry
    scan of K7; the window combine's chain and the reduction's doublings
    in each group; every K2 add: each Hillis-Steele tail and window
    combine (the small scan), each carry add and the weighted reduction's
    adds.  With `sample`, a K5, K6 or K7 call over more than
    SAMPLE_ABOVE_CHUNKS chunks is held on a sample of its block rows
    (`record_sampled`); every other call whole."""
    import torch
    from zukelang_tpu_torch.engine import torch_engine as te
    from zukelang_tpu_torch.ops import kernels as K
    _check_captured_calls(seen, path, n_batches, groups)
    sorts, wsums = seen["digit_sort"], seen["weighted_chunk_sums"]
    scans, dbls = seen["bucket_scan_rows"], seen["point_double_n"]
    jscans, wreds = seen["jac_scan"], seen["run_witness_reduction"]
    levels = _wreduce_levels(sorts[0][0][1]) if sorts else 0
    # block rows (MSMs x windows) of each group's batch
    rows_of = {group: idx.shape[0] for (_r, idx, _s, _k, group, _nb), _kw
               in scans}
    (fc, wm), _kw = wreds[0]
    args = (*te._side_tensors(fc.l, wm.device),
            *te._side_tensors(fc.r, wm.device),
            *te._side_tensors(fc.lhs, wm.device), wm)
    log(f"NTT kernel: the fused witness reduction at the prove's inputs "
        f"(2^{fc.logn}, {fc.n_gates} gates; a, b and h)")
    record("ntt", lambda: te.run_witness_reduction(fc, wm),
           lambda: te.witness_reduction_plain(fc.logn)(*args),
           _witness_reduction_work(fc, args), plain_reps=0)
    for (a, b, spec), _kw in seen["mont_mul"]:
        log(f"K1 mont_mul at the prove's inputs ({spec.name}, "
            f"{tuple(a.shape)})")
        record("mont_mul", lambda: K.mont_mul(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got),
                            a[0].numel() * PRODUCTS[spec.name]),
               plain_reps=0)
    for (pts, kc, *rest), kw in jscans:
        sg = rest[0] if rest else kw.get("seg")
        group = K.group_of(pts[0])
        chunks = pts[0].shape[-1] // kc
        g = K.jac_scan_group(chunks, kc)
        log(f"K7 jac_scan at the prove's inputs ({group}, {chunks} chunks of "
            f"{kc}, seg={sg is not None}, g = {g})")
        smp = (_chunk_sample(chunks, kc, rows_of[group], pts[0].device)
               if sample else None)
        if smp is None:
            record("jac_scan", lambda: K.jac_scan(pts, kc, sg),
                   lambda: K.jac_scan_plain(pts, kc, sg),
                   _jac_scan_work(group, pts, kc, sg), plain_reps=0)
            continue
        _ch, cols, what = smp
        sub = tuple(x[..., cols] for x in pts)
        record_sampled(
            "jac_scan", lambda: K.jac_scan(pts, kc, sg),
            lambda: K.jac_scan_plain(sub, kc, sg[cols] if sg is not None
                                     else None, g),
            lambda got: tuple(x[..., cols] for x in got),
            _jac_scan_work(group, pts, kc, sg), what)
    for (keys, nb), _kw in sorts:
        log(f"K4 digit_sort at the prove's inputs ({tuple(keys.shape)}, "
            f"nb = {nb})")
        record("digit_sort", lambda: K.digit_sort(keys, nb),
               lambda: K.digit_sort_plain(keys, nb),
               lambda got: (_nbytes(keys, got), 0),
               library=lambda: torch.sort(keys, dim=-1, stable=True))
    for (rows, idx, seg, kc, group, nb), _kw in scans:
        B, M = idx.shape[0], idx.shape[1] // kc
        whole = not sample or B * M <= SAMPLE_ABOVE_CHUNKS
        log(f"K5 bucket_scan_rows at the prove's inputs ({group}, "
            f"{'whole' if whole else 'sampled'}: {tuple(idx.shape)} positions "
            f"of a {rows.shape[0]}-row table, K = {kc}, nb = {nb})")
        if whole:
            record("bucket_scan_rows",
                   lambda: K.bucket_scan_rows(rows, idx, seg, kc, group, nb),
                   lambda: K.bucket_scan_rows_plain(rows, idx, seg, kc, group,
                                                    nb),
                   _k5_work(group, rows, idx, seg, kc), plain_reps=0)
            continue
        S = _rows_sample(B)
        rs = torch.tensor(S, device=idx.device)
        lanes = (rs[:, None] * M + torch.arange(M, device=idx.device)).reshape(-1)
        bcols = (rs[:, None] * nb
                 + torch.arange(nb, device=idx.device)).reshape(-1)
        record_sampled(
            "bucket_scan_rows",
            lambda: K.bucket_scan_rows(rows, idx, seg, kc, group, nb),
            lambda: K.bucket_scan_rows_plain(rows, idx[rs], seg[rs], kc, group,
                                             nb),
            lambda got: (tuple(x[..., lanes] for x in got[0]),
                         tuple(x[..., bcols] for x in got[1]), got[2][lanes]),
            _k5_work(group, rows, idx, seg, kc), f"block rows {S} of {B}")
    for i, ((pts, kc), _kw) in enumerate(wsums):
        group = K.group_of(pts[0])
        chunks = pts[0].shape[-1] // kc
        g = K.wsum_group(chunks, kc)
        log(f"K6 weighted_chunk_sums at the prove's inputs ({group}, level "
            f"{i % levels + 1}: {chunks} chunks of {kc}, g = {g})")
        smp = (_chunk_sample(chunks, kc, rows_of[group], pts[0].device)
               if sample else None)
        if smp is None:
            record("weighted_chunk_sums",
                   lambda: K.weighted_chunk_sums(pts, kc),
                   lambda: K.weighted_chunk_sums_plain(pts, kc),
                   _wsum_work(group, pts, kc), plain_reps=1)
            continue
        ch, cols, what = smp
        sub = tuple(x[..., cols] for x in pts)
        record_sampled(
            "weighted_chunk_sums", lambda: K.weighted_chunk_sums(pts, kc),
            lambda: K.weighted_chunk_sums_plain(sub, kc, g),
            lambda got: tuple(tuple(x[..., ch] for x in part) for part in got),
            _wsum_work(group, pts, kc), what)
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
    RUNS[f"pinocchio_2^{log_constraints}"] = run
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


# ---------------------------------------------------------------------------
# Phase 9: the engine seam (TorchEngine under the protocol classes)
# ---------------------------------------------------------------------------

def _check_path_launches(path: str, counts: dict, required) -> None:
    """Every kernel of `required` launched on the path, K8 and the probe
    not at all."""
    _check_launches(path, counts, required)
    off = {k: counts[k] for k in OFF_PATH_KERNELS if counts[k]}
    if off:
        raise AssertionError(f"{path}: kernels of other paths launched: {off}")


def engine_suite_path(dev):
    """Phase 9 (a): the reference suite's 13 programs through the port's
    `run_pipeline` (its Lang-vs-Code cross-check included) for Groth16,
    Pinocchio NonZK and ZK over a `TorchEngine` on the card, on the NTT
    domain; then the frozen x^3 + x + 3 vectors through the engine
    protocols, byte-equal to the golden proofs."""
    import torch
    from zukelang_tpu_torch import vectors
    from zukelang_tpu_torch.core.protocol import registry
    from zukelang_tpu_torch.engine.torch_engine import TorchEngine
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.testing.harness import run_pipeline
    from zukelang_tpu_torch.testing.suites import SUITE

    t_phase = time.time()
    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    for proto in ENGINE_PROTOCOLS:
        t0 = time.time()
        for name, mk in SUITE:
            res = run_pipeline(mk(), registry()[proto](
                engine=TorchEngine(dev)), seed=0, domain="ntt")
            if not res.verified:
                raise AssertionError(f"engine suite: {proto} {name} does not "
                                     "verify")
        log(f"  {proto}: {len(SUITE)} programs proved on the ntt domain and "
            f"verified in {time.time() - t0:.2f} s")
    vec = vectors.load()
    for name, (got, ok) in vectors.engine_prove_all(vec, dev).items():
        if got != vec.proofs[name] or not ok:
            raise AssertionError(f"engine x^3+x+3: {name} proof differs from "
                                 "the golden bytes or does not verify")
        log(f"  x^3+x+3 {name} over the engine: proof bytes equal to the "
            "golden ones, verified")
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    _check_path_launches("engine suite", counts, PROVE_KERNELS)
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, None


def engine_groth16_path(dev, log_constraints: int):
    """Phase 9 (b): Groth16 over a `TorchEngine` on the bench headline's
    circuit (`make_synthetic_r1cs(log_constraints, seed=1)`, its rows as
    gates over `flat.column_var`s, the QAP built directly on the NTT
    domain with no v/w/y: neither keygen nor prove reads them there):
    keygen, one cold and three warm proves, verify, under injected
    scalars; the proof bytes against `groth16_device.prove_device` on the
    same circuit and scalars; the host seconds of the engine's packing
    and unpacking; then the witness reduction's and the first G1 MSM's
    kernel calls, and K3's chain in keygen, against their plain
    versions."""
    import torch
    from zukelang_tpu_torch import bench_lib
    from zukelang_tpu_torch.core import flat, qap as qap_mod
    from zukelang_tpu_torch.core.circuit import Circuit
    from zukelang_tpu_torch.engine.torch_engine import TorchEngine
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.protocols import groth16_device as gd
    from zukelang_tpu_torch.protocols.groth16 import Groth16
    from zukelang_tpu_torch.rng import InjectedRng

    def key():
        return InjectedRng([Fr(k) for k in ENGINE_KEY])

    def prove_rng():
        return InjectedRng([Fr(k) for k in ENGINE_PROVE])

    path = f"engine_groth16_2^{log_constraints}"
    t_phase = time.time()
    inst = bench_lib.make_synthetic_r1cs(log_constraints, seed=1)
    var, V = flat.column_var, len(inst.fc.vars_sorted)
    circuit = Circuit(flat.gates_of(inst.fc), inputs_public={var(0)},
                      outputs={var(V - 1)},
                      mids={var(int(c)) for c in inst.mids_cols})
    n = inst.fc.domain_size
    q = qap_mod.QAP(v={}, w={}, y={},
                    target=[Fr(-1)] + [Fr(0)] * (n - 1) + [Fr(1)],
                    domain="ntt", logn=inst.fc.logn, gates=circuit.gates)
    sol = {var(c): Fr(w) for c, w in enumerate(inst.witness)}
    public = {var(0): sol[var(0)], var(V - 1): sol[var(V - 1)]}
    log(f"build_s {time.time() - t_phase:.3f}  ({len(circuit.gates)} gates "
        f"over {V} variables, domain 2^{q.logn})")

    msm.fixed_base_table_device.cache_clear()   # keygen builds its tables
    K.reset_counts()
    eng = TorchEngine(dev)
    proto = Groth16(eng)
    st = bench_lib._Stages(dev, None)
    keygen_seen = {}

    def keygen():
        keygen_seen.update(_capture_inputs(
            lambda: keygen_seen.setdefault("keys", proto.keygen(
                key(), circuit, q)),
            [(K, "point_madd_chain"), (msm, "_fixed_base_madd")]))
        return keygen_seen["keys"]

    (pk, vk), keygen_s = st.run(keygen)
    keygen_launches, keygen_peak, keygen_host = (st.launches, st.peak_mb,
                                                 eng.host_s)
    proof, prove_first_s = st.run(lambda: proto.prove(prove_rng(), q, pk,
                                                      sol))
    warm = []
    for _ in range(3):
        h0 = eng.host_s
        proof, s = st.run(lambda: proto.prove(prove_rng(), q, pk, sol))
        warm.append(s)
        prove_host = eng.host_s - h0
    per_prove, prove_peak = st.launches, st.peak_mb
    ok, verify_s = st.run(lambda: proto.verify(public, vk, proof))
    counts = dict(K.LAUNCHES)
    log(f"keygen_s {keygen_s:.3f}  (host packing and unpacking "
        f"{keygen_host:.3f} s; peak memory {keygen_peak} MB; launches "
        f"{keygen_launches})")
    log(f"prove_first_s {prove_first_s:.3f}")
    log(f"prove_s {min(warm):.4f}  (warm runs {[round(t, 4) for t in warm]}; "
        f"host packing and unpacking {prove_host:.3f} s of the last; peak "
        f"memory of a prove {prove_peak} MB)")
    log(f"verify_s {verify_s:.3f}  verified {ok}")
    log(f"launches per prove: {per_prove}")
    if not ok:
        raise AssertionError(f"{path}: the proof does not verify")
    _check_path_launches(path, counts, PROVE_KERNELS)
    small = keygen_seen["_fixed_base_madd"]
    if counts["point_madd"] != len(small) or not small:
        raise AssertionError(f"{path}: {counts['point_madd']} K3 launches "
                             f"for {len(small)} small fixed-base batches")

    # the device Groth16 on the same circuit and scalars
    crs, _dvk = gd.keygen_device(inst.fc, inst.mids_cols, inst.ios_cols,
                                 key(), dev)
    wm = inst.pack_witness(dev)
    times = []
    for _ in range(3):
        dproof, s = st.run(lambda: gd.prove_device(crs, inst.fc, wm,
                                                   prove_rng()))
        times.append(s)
    log(f"prove_device prove_s {min(times):.4f}  (warm runs "
        f"{[round(t, 4) for t in times]}) beside the engine's "
        f"{min(warm):.4f}")
    same = all(getattr(proof, p).to_compressed_bytes()
               == getattr(dproof, p).to_compressed_bytes() for p in "abc")
    log(f"engine proof bytes equal to prove_device's: {same}")
    if not same:
        raise AssertionError(f"{path}: the engine's proof differs from "
                             "prove_device's on the same circuit and scalars")

    for (tab, steps, dig, cw), _kw in keygen_seen["point_madd_chain"]:
        log(f"K3 point_madd_chain at the engine keygen's inputs "
            f"({dig.shape[1]} lanes, {steps} windows of 2^{cw})")
        record("point_madd", lambda: K.point_madd_chain(tab, steps, dig, cw),
               lambda: K.point_madd_chain_plain(tab, steps, dig, cw),
               _chain_work(K.group_of(tab[0]), tab, steps, dig, cw, None),
               plain_reps=0)

    def first_steps():
        a, _b, _h = eng.qap_witness_reduction(q, sol)
        eng.g1_apply_powers(a, pk.ti1)

    prove_path_kernel_checks(_capture_inputs(first_steps, _prove_targets()),
                             path, sample=True, n_batches=1, groups=("g1",))
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, per_prove


# ---------------------------------------------------------------------------
# Phase 10: the witness evaluator, the FFT API and bench_msm
# ---------------------------------------------------------------------------

def _sync():
    import torch
    torch.cuda.synchronize()


def _eval_device_split(witness, prog, env, dev):
    """`eval_device`'s three steps, each on the host clock with the card
    synchronised at its end: -> (env, pack_s, levels_s, unpack_s)."""
    t0 = time.perf_counter()
    vals, pois = witness._device_inputs(prog, env, dev)
    _sync()
    t1 = time.perf_counter()
    witness._run_levels(prog, vals, pois)
    _sync()
    t2 = time.perf_counter()
    got = witness._device_finish(prog, env, vals, pois)
    return got, t1 - t0, t2 - t1, time.perf_counter() - t2


def _traced_levels(witness, K, prog, env, dev):
    """One more `eval_device` with K1's launches counted and the host
    seconds taken (the card synchronised before and after) per level and
    kind, and the products' operands kept: -> (env, [(kind, launches,
    seconds)], {(op index, kind): [(a, b, spec)]})."""
    per_op, calls, current = [], {}, {}
    orig_level, orig_mul = witness._level, K.mont_mul

    def level(vals, pois, op, one, zero):
        current["op"] = (len(per_op), op.kind)
        before = K.LAUNCHES["mont_mul"]
        _sync()
        t0 = time.perf_counter()
        out = orig_level(vals, pois, op, one, zero)
        _sync()
        per_op.append((op.kind, K.LAUNCHES["mont_mul"] - before,
                       time.perf_counter() - t0))
        return out

    def mont_mul(a, b, spec):
        calls.setdefault(current["op"], []).append((a, b, spec))
        return orig_mul(a, b, spec)

    witness._level, K.mont_mul = level, mont_mul
    try:
        got = witness.eval_device(prog, env, dev)
    finally:
        witness._level, K.mont_mul = orig_level, orig_mul
    return got, per_op, calls


def _witness_sweep(dev):
    """eval_host against eval_device (the minimum of three warm runs each,
    host clock; the device's result comes back to the host) on the wide
    program at each WITNESS_SWEEP lane count; -> the least lanes from
    which eval_device is the faster, or None."""
    from zukelang_tpu_torch.core import witness
    from zukelang_tpu_torch.testing.witness_programs import wide_program
    crossover = None
    for lanes in WITNESS_SWEEP:
        codes, env = wide_program(lanes, WITNESS_LEVELS, seed=lanes)
        prog = witness.compile_witness_program(codes, list(env))
        want = witness.eval_host(prog, env)
        if witness.eval_device(prog, env, dev) != want:
            raise AssertionError(f"witness sweep: eval_device differs from "
                                 f"eval_host at {lanes} lanes")
        times = {}
        for name, fn in (("eval_host", lambda: witness.eval_host(prog, env)),
                         ("eval_device", lambda: witness.eval_device(
                             prog, env, dev))):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                runs.append(time.perf_counter() - t0)
            times[name] = min(runs)
        faster = times["eval_device"] < times["eval_host"]
        if faster and crossover is None:
            crossover = lanes
        elif not faster:
            crossover = None
        log(f"  {lanes} lanes x {WITNESS_LEVELS} levels ({prog.n_steps} "
            f"steps): eval_host_s {times['eval_host']:.5f}  eval_device_s "
            f"{times['eval_device']:.5f}  "
            f"({'eval_device' if faster else 'eval_host'} faster)")
    log(f"eval_device faster from {crossover} lanes on"
        if crossover else "eval_device never faster in the sweep")
    return crossover


def witness_wide_path(dev):
    """Phase 10 (a): the synthetic wide program (`testing/
    witness_programs.wide_program`, WITNESS_LANES lanes x WITNESS_LEVELS
    levels over as many secret inputs and ONE, a quarter of its lanes
    dividing by zero in an untaken branch) through `eval_device` on the
    card, cold then three warm runs split into pack / levels / unpack,
    each equal to `eval_host`; K1's launches and seconds a run, the `div`
    level's apart; K1 against its plain version on the div level's own products
    (every call; the first and the last timed) and one mul level's; then
    the crossover sweep."""
    from zukelang_tpu_torch.core import witness
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.testing.witness_programs import wide_program

    t_phase = time.time()
    codes, env = wide_program(WITNESS_LANES, WITNESS_LEVELS, seed=10)
    t0 = time.time()
    prog = witness.compile_witness_program(codes, list(env))
    compile_s = time.time() - t0
    t0 = time.time()
    want = witness.eval_host(prog, env)
    eval_host_s = time.time() - t0
    log(f"program: {prog.n_steps} steps in {len(prog.levels)} levels over "
        f"{len(env)} inputs (ONE included): "
        f"{[lv[0].kind for lv in prog.levels]}")
    log(f"compile_s {compile_s:.3f}  eval_host_s {eval_host_s:.4f}")

    K.reset_counts()
    _sync()
    t0 = time.perf_counter()
    if witness.eval_device(prog, env, dev) != want:
        raise AssertionError("witness: eval_device differs from eval_host")
    log(f"eval_device_s cold {time.perf_counter() - t0:.4f} (the plan built "
        "and copied to the card)")
    for i in range(3):
        got, pack_s, levels_s, unpack_s = _eval_device_split(witness, prog,
                                                             env, dev)
        if got != want:
            raise AssertionError("witness: eval_device differs from "
                                 "eval_host")
        log(f"eval_device_s warm {pack_s + levels_s + unpack_s:.4f}: pack "
            f"{pack_s:.4f}  levels {levels_s:.4f}  unpack {unpack_s:.4f}")
    got, per_op, calls = _traced_levels(witness, K, prog, env, dev)
    counts = dict(K.LAUNCHES)
    if got != want:
        raise AssertionError("witness: eval_device differs from eval_host")
    div = [(n, t) for kind, n, t in per_op if kind == "div"]
    rest = [(n, t) for kind, n, t in per_op if kind != "div"]
    log(f"K1 launches a run: {sum(n for _k, n, _t in per_op)} over "
        f"{len(prog.levels)} levels: the div level {sum(n for n, _ in div)} "
        f"in {sum(t for _, t in div):.5f} s, the others "
        f"{[n for n, _ in rest]} in {sum(t for _, t in rest):.5f} s (host "
        "clock, the card synchronised around each level's kind)")
    _check_path_launches("witness wide", counts, SLICE_KERNELS["witness"])

    div_calls = next(v for (_i, kind), v in calls.items() if kind == "div")
    mul_calls = next(v for (_i, kind), v in calls.items() if kind == "mul")
    worst = max(_max_err(K.mont_mul(a, b, spec), K.mont_mul_plain(a, b, spec))
                for a, b, spec in div_calls)
    log(f"K1 mont_mul on the div level's {len(div_calls)} products: "
        f"max_abs_err {worst}")
    if worst:
        raise AssertionError("witness: K1 disagrees with plain on the div "
                             "level")
    for what, (a, b, spec) in (
            ("the div level's first product (a square)", div_calls[0]),
            ("the div level's last product (the quotient)", div_calls[-1]),
            ("the first mul level's product", mul_calls[0])):
        log(f"K1 mont_mul at the witness program's inputs: {what}, "
            f"{tuple(a.shape)}")
        record("mont_mul", lambda: K.mont_mul(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got),
                            a[0].numel() * PRODUCTS[spec.name]),
               plain_reps=0)
    log("eval_host against eval_device by width:")
    _witness_sweep(dev)
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, None


def witness_suite_path(dev):
    """Phase 10 (b): the reference suite's 13 programs through
    `eval_device` on the card against `comp.code_eval_list` (seed 5), then
    the two poison cases: 1/0 raises ZeroDivisionError, a division by zero
    in the untaken branch of the Or gadget does not."""
    from zukelang_tpu_torch.core import comp, lang as L, witness
    from zukelang_tpu_torch.core.circuit import ONE
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.rng import Gen
    from zukelang_tpu_torch.testing.suites import SUITE

    def zero_inputs(c):
        env = {vs[0]: Fr(0) for name, (_s, _t, vs) in c.inputs.items()
               if name != "$ONE"}
        env[ONE] = Fr(1)
        return env

    t_phase = time.time()
    K.reset_counts()
    for name, mk in SUITE:
        c = comp.compile_expr(mk())
        _i, _l, env = comp.gen_inputs(c.inputs, Gen(5))
        gvars = c.circuit.vars()
        env = {v: f for v, f in env.items() if v in gvars}
        prog = witness.compile_witness_program(c.codes, list(env))
        if witness.eval_device(prog, env, dev) != comp.code_eval_list(
                env, c.codes):
            raise AssertionError(f"witness suite: {name} differs from "
                                 "code_eval_list")
        log(f"  {name}: {prog.n_steps} steps in {len(prog.levels)} levels, "
            "equal to code_eval_list")
    x = L.input("x", L.SECRET, L.ty_field)
    c = comp.compile_expr(L.let_(x, lambda v: L.div(L.fnum(1), v)))
    env = zero_inputs(c)
    prog = witness.compile_witness_program(c.codes, list(env))
    try:
        witness.eval_device(prog, env, dev)
        raise AssertionError("witness suite: 1/0 did not raise")
    except ZeroDivisionError:
        log("  1/0: ZeroDivisionError, as code_eval_list")
    a = L.input("a", L.SECRET, L.ty_bool)
    b = L.input("b", L.SECRET, L.ty_bool)
    c = comp.compile_expr(L.let_(a, lambda av: L.let_(
        b, lambda bv: L.or_(av, bv))))
    env = zero_inputs(c)
    prog = witness.compile_witness_program(c.codes, list(env))
    if witness.eval_device(prog, env, dev) != comp.code_eval_list(env,
                                                                  c.codes):
        raise AssertionError("witness suite: the untaken division differs")
    log("  false or false: the untaken division by zero raises nothing, "
        "equal to code_eval_list")
    _sync()
    counts = dict(K.LAUNCHES)
    _check_path_launches("witness suite", counts, SLICE_KERNELS["witness"])
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, None


def fft_path(dev):
    """Phase 10 (c): `polynomial_mul_fr` of two 2^(FFT_LOG-1)-coefficient
    polynomials on the card against the host library's route (`native.
    fr_ntt` of both, `fr_mul_batch`, the inverse `fr_ntt`); the `fft_fr` /
    `ifft_fr` round trip at 2^FFT_LOG, the forward transform equal to
    `native.fr_ntt`'s; the NTT kernel's calls and K1's product against
    their plain versions on these inputs; `fft_c` at 2^FFT_LOG against
    numpy's FFT (FFT_C_ATOL)."""
    import numpy as np
    from zukelang_tpu_torch import native
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import fft, ntt
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.params import FR

    t_phase = time.time()
    rng = random.Random(16)
    n = 1 << FFT_LOG
    p1 = [Fr(rng.randrange(FR.p)) for _ in range(n // 2)]
    p2 = [Fr(rng.randrange(FR.p)) for _ in range(n // 2)]
    coeffs = p1 + p2
    K.reset_counts()
    out = {}
    t0 = time.time()
    seen = _capture_inputs(
        lambda: out.setdefault("prod", fft.polynomial_mul_fr(p1, p2, dev)),
        [(ntt, "ntt"), (ntt, "intt"), (K, "mont_mul")])
    mul_s = time.time() - t0
    t0 = time.time()
    vals = fft.fft_fr(coeffs, device=dev)
    fft_s = time.time() - t0
    t0 = time.time()
    back = fft.ifft_fr(vals, device=dev)
    ifft_s = time.time() - t0
    _sync()
    counts = dict(K.LAUNCHES)
    log(f"polynomial_mul_fr 2 x {n // 2} coefficients: {mul_s:.4f} s; "
        f"fft_fr 2^{FFT_LOG}: {fft_s:.4f} s; ifft_fr: {ifft_s:.4f} s (host "
        "clock, packing and unpacking included)")
    if back != coeffs:
        raise AssertionError("fft: ifft_fr(fft_fr(p)) != p")
    t0 = time.time()
    pad = [Fr(0)] * (n // 2)
    ea, eb = native.fr_ntt(p1 + pad), native.fr_ntt(p2 + pad)
    want = native.fr_ntt(native.fr_mul_batch(ea, eb), inverse=True)[:n - 1]
    native_s = time.time() - t0
    same = out["prod"] == want and native.fr_ntt(coeffs) == vals
    log(f"host library route (fr_ntt, fr_mul_batch, inverse fr_ntt): "
        f"{native_s:.4f} s; equal to polynomial_mul_fr, and fr_ntt to "
        f"fft_fr: {same}")
    if not same:
        raise AssertionError("fft: differs from the host library's route")
    _check_path_launches(f"fft 2^{FFT_LOG}", counts, SLICE_KERNELS["fft"])

    for form in ("ntt", "intt"):
        for (x, *_r), _kw in seen[form]:
            log(f"NTT kernel ({form}) at polynomial_mul_fr's inputs "
                f"({tuple(x.shape)})")
            record("ntt", lambda: getattr(ntt, form)(x),
                   lambda: getattr(ntt, form + "_plain")(x),
                   _ntt_work(x[None], form), plain_reps=0)
    for (a, b, spec), _kw in seen["mont_mul"]:
        log(f"K1 mont_mul at polynomial_mul_fr's inputs ({tuple(a.shape)})")
        record("mont_mul", lambda: K.mont_mul(a, b, spec),
               lambda: K.mont_mul_plain(a, b, spec),
               lambda got: (_nbytes(a, b, got),
                            a[0].numel() * PRODUCTS[spec.name]),
               plain_reps=0)

    z = np.random.RandomState(16).uniform(-1, 1, (2, n))
    z = z[0] + 1j * z[1]
    t0 = time.time()
    zf = fft.fft_c(z, device=dev)
    fft_c_s = time.time() - t0
    err = float(np.abs(zf - np.fft.fft(z)).max())
    err_back = float(np.abs(fft.ifft_c(zf, device=dev) - z).max())
    log(f"fft_c 2^{FFT_LOG} (complex128): {fft_c_s:.4f} s; max |err| against "
        f"numpy {err:.3e}, round trip {err_back:.3e} (tolerance "
        f"{FFT_C_ATOL})")
    if err > FFT_C_ATOL or err_back > FFT_C_ATOL:
        raise AssertionError("fft_c differs from numpy's FFT")
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, None


def _lane_runs(n: int, per: int, device):
    """(columns, what) of four runs of `per` of n lanes: the first, two
    between and the last."""
    import torch
    runs = _rows_sample(n // per)
    cols = torch.cat([torch.arange(r * per, (r + 1) * per, device=device)
                      for r in runs])
    return cols, f"lane runs {runs} of {n // per} ({per} lanes each)"


def _msm_call_checks():
    """{(module, wrapper name): check(fn, args, kwargs)} for every kernel
    wrapper an MSM calls: each call held against its plain version where
    it happens, the kernel timed over 3 calls, the row kept quietly.  A
    K2 add over more than SAMPLE_ABOVE_LANES lanes is held on four runs
    of lanes, a K7 scan of more than SAMPLE_SCAN_CHUNKS chunks on four
    runs of chunks, K5 above SAMPLE_ABOVE_CHUNKS chunks on a sample of its
    block rows."""
    import torch
    from zukelang_tpu_torch.ops import kernels as K

    def rec(name, kern, plain, work, library=None):
        record(name, kern, plain, work, reps=3, plain_reps=0,
               library=library, echo=False)

    def add(fn, a, kw):
        P, Q = a[:2]
        n = P[0].shape[-1]
        work = _add_work(K.group_of(P[0]), P, Q)
        if n <= SAMPLE_ABOVE_LANES:
            rec("point_add", lambda: fn(*a, **kw),
                lambda: K.point_add_plain(P, Q), work)
            return
        cols, what = _lane_runs(n, SAMPLE_ABOVE_LANES // 4, P[0].device)

        def sub(T):
            return tuple(x[..., cols] for x in T)
        record_sampled("point_add", lambda: fn(*a, **kw),
                       lambda: K.point_add_plain(sub(P), sub(Q)), sub, work,
                       what, reps=3, echo=False)

    def carry(fn, a, kw):
        P, car, idx = a[:3]
        rec("point_add", lambda: fn(*a, **kw),
            lambda: K.point_add_carry_plain(P, car, idx),
            _carry_work(K.group_of(P[0]), P, car, idx))

    def small(fn, a, kw):
        pts, seg = a[:2]
        rec("point_add", lambda: fn(*a, **kw),
            lambda: K.seg_scan_small_plain(pts, seg),
            _seg_scan_small_work(K.group_of(pts[0]), pts, seg))

    def jscan(fn, a, kw):
        pts, kc = a[:2]
        seg = a[2] if len(a) > 2 else kw.get("seg")
        n = pts[0].shape[-1]
        g = kw.get("g") or K.jac_scan_group(n // kc, kc)
        work = _jac_scan_work(K.group_of(pts[0]), pts, kc, seg)
        if n // kc <= SAMPLE_SCAN_CHUNKS:
            rec("jac_scan", lambda: fn(*a, **kw),
                lambda: K.jac_scan_plain(pts, kc, seg, g), work)
            return
        cols, what = _lane_runs(n, kc * SAMPLE_SCAN_CHUNKS // 4,
                                pts[0].device)
        record_sampled(
            "jac_scan", lambda: fn(*a, **kw),
            lambda: K.jac_scan_plain(tuple(x[..., cols] for x in pts), kc,
                                     seg[cols] if seg is not None else None,
                                     g),
            lambda got: tuple(x[..., cols] for x in got), work, what, reps=3,
            echo=False)

    def dbl(fn, a, kw):
        pts, counts = a[:2]
        rec("point_double", lambda: fn(*a, **kw),
            lambda: K.point_double_n_plain(pts, counts),
            _double_work(K.group_of(pts[0]), pts, counts))

    def wsum(fn, a, kw):
        pts, kc = a[:2]
        rec("weighted_chunk_sums", lambda: fn(*a, **kw),
            lambda: K.weighted_chunk_sums_plain(pts, kc, kw.get("g")),
            _wsum_work(K.group_of(pts[0]), pts, kc))

    def dsort(fn, a, kw):
        keys, nb = a[:2]
        rec("digit_sort", lambda: fn(*a, **kw),
            lambda: K.digit_sort_plain(keys, nb),
            lambda got: (_nbytes(keys, got), 0),
            library=lambda: torch.sort(keys, dim=-1, stable=True))

    def k5(fn, a, kw):
        rows, idx, seg, kc, group = a[:5]
        nb = a[5] if len(a) > 5 else kw.get("nb")
        B, M = idx.shape[0], idx.shape[1] // kc
        work = _k5_work(group, rows, idx, seg, kc)
        if B * M <= SAMPLE_ABOVE_CHUNKS:
            rec("bucket_scan_rows", lambda: fn(*a, **kw),
                lambda: K.bucket_scan_rows_plain(rows, idx, seg, kc, group,
                                                 nb), work)
            return
        S = _rows_sample(B)
        rs = torch.tensor(S, device=idx.device)
        lanes = (rs[:, None] * M
                 + torch.arange(M, device=idx.device)).reshape(-1)
        bcols = (rs[:, None] * nb
                 + torch.arange(nb, device=idx.device)).reshape(-1)
        record_sampled(
            "bucket_scan_rows", lambda: fn(*a, **kw),
            lambda: K.bucket_scan_rows_plain(rows, idx[rs], seg[rs], kc,
                                             group, nb),
            lambda got: (tuple(x[..., lanes] for x in got[0]),
                         tuple(x[..., bcols] for x in got[1]), got[2][lanes]),
            work, f"block rows {S} of {B}", reps=3)

    return {(K, "point_add"): add, (K, "point_add_carry"): carry,
            (K, "seg_scan_small"): small, (K, "jac_scan"): jscan,
            (K, "point_double_n"): dbl, (K, "weighted_chunk_sums"): wsum,
            (K, "digit_sort"): dsort, (K, "bucket_scan_rows"): k5}


def _check_at_call(what: str, run, checks):
    """run() with each wrapper of `checks` replaced by one that holds the
    call against its plain version first (`_msm_call_checks`); logs each
    kernel's calls and their summed kernel time; -> run()'s result."""
    before = {k: len(v) for k, v in RESULTS.items()}
    orig = {name: (m, getattr(m, name)) for m, name in checks}

    def wrap(fn, check):
        def call(*a, **kw):
            check(fn, a, kw)
            return fn(*a, **kw)
        return call
    try:
        for (m, name), check in checks.items():
            setattr(m, name, wrap(orig[name][1], check))
        out = run()
    finally:
        for name, (m, fn) in orig.items():
            setattr(m, name, fn)
    for k, rows in RESULTS.items():
        new = rows[before.get(k, 0):]
        if new:
            log(f"  {what}: {k}: {len(new)} calls equal to their plain "
                f"versions (max_abs_err {max(r['err'] for r in new)}; kernel "
                f"{sum(r['ms'] for r in new):.3f} ms, plain "
                f"{sum(r['plain_ms'] for r in new):.1f} ms, in all)")
    return out


def bench_msm_path(dev):
    """Phase 10 (d): `bench_msm.main` at 2^MSM_BENCH_LOG, at the auto window
    and at c = MSM_BENCH_C, each on Jacobian and affine bases: the four
    results equal, and equal to the host library's `native.g1_msm` on the
    same points and scalars (run in a thread beside what follows); `main`
    at 2^GOLDEN_LOG against golden `G1.dot` (its OK lines); then every
    kernel call of one Jacobian and of one affine MSM at 2^MSM_BENCH_LOG,
    c = MSM_BENCH_C, against its plain version (`_check_at_call`, the
    samples of `_msm_call_checks`)."""
    from zukelang_tpu_torch import bench_msm, native
    from zukelang_tpu_torch.golden.field import Fr
    from zukelang_tpu_torch.ops import curve as C
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm

    t_phase = time.time()
    logn = MSM_BENCH_LOG
    log(f"auto_window(2^{logn}) = {msm.auto_window(1 << logn)}")
    K.reset_counts()
    runs = [bench_msm.main([str(logn)]),
            bench_msm.main([str(logn), str(MSM_BENCH_C)])]
    found = [pt for r in runs for pt in r["results"].values()]
    log(f"bench_msm at 2^{logn}: {len(found)} results ("
        f"{[k for r in runs for k in r['results']]}), all equal: "
        f"{all(pt == found[0] for pt in found)}")
    if any(pt != found[0] for pt in found):
        raise AssertionError("bench_msm: the Jacobian and affine results "
                             "differ")
    out = runs[-1]
    pts = C.unpack_g1(C.affine_to_jac(out["affine"]))
    scalars = [Fr(s) for s in out["scalars"]]

    def host_msm():
        t0 = time.time()
        return native.g1_msm(pts, scalars), time.time() - t0

    # the host library's MSM (seconds of one host core) runs in a thread
    # beside the rest of the phase; ctypes releases the interpreter lock
    with ThreadPoolExecutor(1) as pool:
        native_run = pool.submit(host_msm)
        bench_msm.main([str(GOLDEN_LOG)])
        _sync()
        counts = dict(K.LAUNCHES)
        _check_path_launches(f"bench_msm 2^{logn}", counts,
                             SLICE_KERNELS["bench_msm"])
        P, S, A = out["points"], out["scalars_std"], out["affine"]
        checks = _msm_call_checks()
        for tag, bases in (("jac", P), ("aff", A)):
            log(f"every kernel call of one MSM[{tag}] at 2^{logn}, c = "
                f"{MSM_BENCH_C}, against its plain version")
            got = _check_at_call(f"MSM[{tag}]", lambda: msm.msm_staged(
                bases, S, "g1", MSM_BENCH_C), checks)
            if got != found[0]:
                raise AssertionError(f"bench_msm: the checked MSM[{tag}] "
                                     "differs")
        want, native_s = native_run.result()
    log(f"native.g1_msm at 2^{logn}: {native_s:.2f} s on a host thread "
        f"beside the checks; equal to bench_msm's: {want == found[0]}")
    if want != found[0]:
        raise AssertionError("bench_msm: differs from native.g1_msm")
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return counts, None


# ---------------------------------------------------------------------------
# Phase 11: the multi-rank slice (parallel/) on a world of one NCCL rank
# ---------------------------------------------------------------------------

def _sharded_call_checks():
    """`_msm_call_checks` and K1's and the NTT kernel's calls, each held
    whole."""
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import ntt
    checks = _msm_call_checks()

    def mul(fn, a, kw):
        x, y, spec = a[:3]
        record("mont_mul", lambda: fn(*a, **kw),
               lambda: K.mont_mul_plain(x, y, spec),
               lambda got: (_nbytes(x, y, got),
                            x[0].numel() * PRODUCTS[spec.name]),
               reps=3, plain_reps=0, echo=False)

    def transform(fn, a, kw):
        x, logn = a[:2]
        record("ntt", lambda: fn(*a, **kw),
               lambda: ntt.transform_plain(x, logn, **kw),
               _ntt_work(x, "intt" if kw["inverse"] else "ntt"),
               reps=3, plain_reps=0, echo=False)

    checks.update({(K, "mont_mul"): mul, (ntt, "transform"): transform})
    return checks


def _sharded_run(dev, proto: str):
    """The keypair, instance and witness of phase 4's Groth16 run or phase
    5's Pinocchio run, or a new run where phase 11 runs alone."""
    from zukelang_tpu_torch import bench_lib
    if proto == "groth16":
        key = f"groth16_2^{LOG_CONSTRAINTS}"
        if key not in RUNS:
            RUNS[key] = bench_lib.run_groth16(LOG_CONSTRAINTS, seed=1,
                                              repeats=1, device=dev)
    else:
        key = f"pinocchio_2^{PIN_LOG_CONSTRAINTS}"
        if key not in RUNS:
            RUNS[key] = bench_lib.run_pinocchio(PIN_LOG_CONSTRAINTS, seed=1,
                                                repeats=1, zk=True, device=dev)
    return RUNS[key]


def _timed_split(mesh, prove):
    """One more prove with the witness reduction and each sharded MSM
    timed on the host clock (the card synchronised around each), its
    launches by kernel, collectives and their bytes, and peak memory:
    -> (proof, dict of the figures)."""
    import torch
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.parallel import sharded
    spent = {"witness_reduction_s": 0.0, "msm_s": 0.0}
    orig = {n: getattr(sharded, n) for n in ("sharded_witness_reduction",
                                             "sharded_msm")}

    def timed(name, key):
        def call(*a, **kw):
            _sync()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            _sync()
            spent[key] += time.perf_counter() - t0
            return out
        return call
    before, coll = dict(K.LAUNCHES), dict(mesh.counts)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        sharded.sharded_witness_reduction = timed(
            "sharded_witness_reduction", "witness_reduction_s")
        sharded.sharded_msm = timed("sharded_msm", "msm_s")
        proof = prove()
    finally:
        for n, fn in orig.items():
            setattr(sharded, n, fn)
    total = time.perf_counter() - t0
    spent["rest_s"] = total - spent["witness_reduction_s"] - spent["msm_s"]
    spent["prove_s"] = total
    spent["launches"] = _diff(K.LAUNCHES, before)
    spent["collectives"] = _diff(mesh.counts, coll)
    spent["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    return proof, spent


def _sharded_prove_path(dev, mesh, proto: str, checks=None):
    """Phase 11 (a) and (b): a cold and three warm sharded proves from
    zeroed counts (every kernel of SHARDED_KERNELS launched, neither K8 nor
    the looped probe), one more with its split, launches, collectives and
    peak memory; `prove_device` under the same rng (equal proof, three
    warm proves timed) and verify; with `checks` (`_sharded_call_checks`),
    one more sharded prove with each kernel call held against its plain
    version."""
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.parallel import sharded
    from zukelang_tpu_torch.protocols import groth16_device as gd
    from zukelang_tpu_torch.protocols import pinocchio_device as pd
    from zukelang_tpu_torch.protocols.pinocchio import PROOF_FIELDS
    from zukelang_tpu_torch.rng import Gen

    run = _sharded_run(dev, proto)
    fc, wm = run.inst.fc, run.witness
    if proto == "groth16":
        fields = ("a", "b", "c")

        def prove():
            return sharded.sharded_groth16_prove(
                mesh, run.crs, fc, wm, Gen(b"sharded-prove"), c=SHARDED_C)

        def reference():
            return gd.prove_device(run.crs, fc, wm, Gen(b"sharded-prove"))
        verify = gd.verify
    else:
        fields = PROOF_FIELDS

        def prove():
            return sharded.sharded_pinocchio_prove(
                mesh, run.pkey, fc, wm, Gen(b"sharded-prove"), zk=True,
                c=SHARDED_C)

        def reference():
            return pd.prove_device(run.pkey, fc, wm, Gen(b"sharded-prove"),
                                   zk=True)
        verify = pd.verify
    path = f"sharded_{proto}_2^{run.log_constraints}"
    K.reset_counts()
    t0 = time.time()
    proof = prove()
    cold = time.time() - t0
    warm = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        prove()
        warm.append(time.perf_counter() - t0)
    _sync()
    counts = dict(K.LAUNCHES)
    _check_path_launches(path, counts, SHARDED_KERNELS)
    _p, split = _timed_split(mesh, prove)
    ref = reference()
    dev_warm = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        reference()
        dev_warm.append(time.perf_counter() - t0)
    same = all(getattr(proof, f) == getattr(ref, f) for f in fields)
    ok = verify(run.public, run.vkey, proof)
    log(f"{path}: sharded prove_first_s {cold:.3f}, prove_s "
        f"{min(warm):.4f} (warm {[round(t, 4) for t in warm]}); "
        f"prove_device prove_s {min(dev_warm):.4f} (warm "
        f"{[round(t, 4) for t in dev_warm]}); equal to prove_device's "
        f"proof: {same}; verified: {ok}")
    log(f"  split of one prove: witness reduction "
        f"{split['witness_reduction_s']:.4f} s, MSMs {split['msm_s']:.4f} s, "
        f"rest {split['rest_s']:.4f} s of {split['prove_s']:.4f} s; peak "
        f"memory {split['peak_mb']:.1f} MB")
    log(f"  launches a prove: "
        f"{ {k: v for k, v in split['launches'].items() if v} }")
    log(f"  collectives a prove (bytes handed to them): "
        f"{split['collectives']}")
    if not same or not ok:
        raise AssertionError(f"{path}: the sharded proof differs from "
                             "prove_device's or does not verify")
    if checks is not None:
        log(f"every kernel call of one more {path} prove against its plain "
            "version")
        got = _check_at_call(path, prove, checks)
        if any(getattr(got, f) != getattr(proof, f) for f in fields):
            raise AssertionError(f"{path}: the checked prove differs")
    return path, counts, split["launches"]


def _sharded_ntt_checks(dev, mesh):
    """Phase 11 (c): the host twiddle tables' build, `sharded_ntt` against
    `ops.ntt.ntt` and `sharded_intt` against `intt` (the four-step output
    flattened is natural order), and `sharded_ntt_phase_times`, at each
    SHARDED_NTT_LOGS size.  -> the launch counts from zero."""
    import torch
    from zukelang_tpu_torch.ops import field as F
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import ntt
    from zukelang_tpu_torch.parallel import sharded
    from zukelang_tpu_torch.params import FR

    K.reset_counts()
    rng = random.Random(11)
    for logn in SHARDED_NTT_LOGS:
        n = 1 << logn
        log1, log2 = sharded._split_logs(logn, mesh.size)
        sharded._twiddle_matrix.cache_clear()
        t0 = time.time()
        for inverse in (False, True):
            sharded._twiddle_matrix(log1, log2, inverse)
        table_s = time.time() - t0
        x = F.pack_mont([rng.randrange(FR.p) for _ in range(n)], FR, dev)
        y = mesh.gather(sharded.sharded_ntt(
            mesh, x.reshape(FR.nl, 1 << log1, 1 << log2), log1, log2), 2)
        yi = mesh.gather(sharded.sharded_intt(mesh, x, log1, log2), 2)
        ok = (torch.equal(y.reshape(FR.nl, n), ntt.ntt(x))
              and torch.equal(yi.reshape(FR.nl, n), ntt.intt(x)))
        pt = sharded.sharded_ntt_phase_times(
            mesh, x.reshape(FR.nl, 1 << log1, 1 << log2), log1, log2)
        log(f"sharded NTT 2^{logn} = 2^{log1} x 2^{log2}: host twiddle "
            f"tables (both directions, built anew) {table_s:.3f} s; "
            f"sharded_ntt == "
            f"ntt and sharded_intt == intt: {ok}; phases (s) "
            f"{json.dumps(pt)}")
        if not ok:
            raise AssertionError(f"sharded NTT 2^{logn} differs from ntt")
    _sync()
    return dict(K.LAUNCHES)


def _golden_msm(msm_log: int):
    """The dry run's golden G1.dot, in a process of its own (compressed
    bytes: the port's points are its own classes)."""
    from zukelang_tpu_torch.parallel import dryrun
    return dryrun.msm_golden(msm_log).to_compressed_bytes()


def _scaling_world(mesh):
    """`measure_msm_scaling(SCALING_MSM_LOG, c=DRYRUN_C)` and
    `measure_ntt_scaling(SCALING_NTT_LOG)` at the world of `mesh`: the
    harness's rank targets run on it in this process (a spawned world's
    launches would not be this process's), with the harness's keys; the
    efficiency of a world of one is 1 by its definition."""
    from zukelang_tpu_torch.parallel import scaling
    d = mesh.size
    t = float(scaling.msm_rank(mesh, SCALING_MSM_LOG, DRYRUN_C,
                               None)["time_s"])
    msm_res = {d: {"time_s": t,
                   "mterms_per_s": (1 << SCALING_MSM_LOG) / t / 1e6,
                   "efficiency": 1.0}}
    nt = scaling.ntt_rank(mesh, SCALING_NTT_LOG, 3, True)
    t = float(nt["time_s"])
    ntt_res = {d: {"time_s": t,
                   "melems_per_s": (1 << SCALING_NTT_LOG) / t / 1e6,
                   "efficiency": 1.0,
                   "phase_breakdown": {k[len("phase."):]: float(v)
                                       for k, v in nt.items()
                                       if k.startswith("phase.")}}}
    return msm_res, ntt_res


def sharded_paths(dev):
    """Phase 11: the sharded paths on a world of one NCCL rank in this
    process (`launch.init_world1`): (a) Groth16 at 2^16 and (b) Pinocchio
    ZK at 2^14 (pad 2^16) over `sharded_*_prove` against `prove_device`,
    (c) the four-step NTT at 2^16 and 2^20, (d) the dry run's c = 8 G1
    MSM at 2^GOLDEN_LOG against golden `G1.dot` (computed in a process
    of its own beside (a)-(c)), then the scaling harness at the phase's
    world (`_scaling_world`); (e) every kernel call of one more (a)
    prove, of (d)'s MSM and of one NTT of (d)'s scaling target against
    its plain version.  -> {path: (counts, launches a prove)}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from zukelang_tpu_torch.golden.curve import G1
    from zukelang_tpu_torch.ops import field as F
    from zukelang_tpu_torch.ops import kernels as K
    from zukelang_tpu_torch.ops import msm
    from zukelang_tpu_torch.params import FR
    from zukelang_tpu_torch.parallel import dryrun, launch, scaling, sharded

    t_phase = time.time()
    paths = {}
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool, \
            launch.init_world1("cuda") as mesh:
        golden = pool.submit(_golden_msm, GOLDEN_LOG)
        log(f"phase 11 (a): sharded Groth16 at 2^{LOG_CONSTRAINTS}, c = "
            f"{SHARDED_C}, world of {mesh.size} ({mesh.device})")
        checks = _sharded_call_checks()
        path, counts, per = _sharded_prove_path(dev, mesh, "groth16", checks)
        paths[path] = (counts, per)
        log(f"phase 11 (b): sharded Pinocchio ZK at 2^{PIN_LOG_CONSTRAINTS}")
        path, counts, per = _sharded_prove_path(dev, mesh, "pinocchio")
        paths[path] = (counts, per)
        log("phase 11 (c): the four-step NTT at "
            f"{', '.join(f'2^{k}' for k in SHARDED_NTT_LOGS)}")
        paths["sharded_ntt"] = (_sharded_ntt_checks(dev, mesh), None)
        log(f"phase 11 (d): the dry run's c = {DRYRUN_C} G1 MSM at "
            f"2^{GOLDEN_LOG}, then the scaling harness at world {mesh.size}")
        sc, ks = dryrun.msm_inputs(GOLDEN_LOG)
        pts = msm.fixed_base_mul(F.pack(ks, FR, dev), group="g1", c=4)
        S = F.pack(sc, FR, dev)
        K.reset_counts()
        t0 = time.time()
        got = sharded.sharded_msm(mesh, pts, S, "g1", c=DRYRUN_C)
        _sync()
        msm_s = time.time() - t0
        scaled = _scaling_world(mesh)
        _sync()
        counts = dict(K.LAUNCHES)
        path = f"sharded_msm_c{DRYRUN_C}_2^{GOLDEN_LOG}+scaling"
        _check_path_launches(path, counts, SHARDED_MSM_KERNELS)
        paths[path] = (counts, None)
        for name, res in zip(
                (f"measure_msm_scaling({SCALING_MSM_LOG}, c={DRYRUN_C})",
                 f"measure_ntt_scaling({SCALING_NTT_LOG})"), scaled):
            log(f"{name} at world {mesh.size}, its rank target in this "
                f"process: {json.dumps(res)}")
        log(f"every kernel call of the c = {DRYRUN_C} MSM and of one NTT "
            "of the scaling target against its plain version")
        again = _check_at_call("sharded c=8 MSM", lambda: sharded.sharded_msm(
            mesh, pts, S, "g1", c=DRYRUN_C), checks)
        _check_at_call(f"scaling NTT 2^{SCALING_NTT_LOG}",
                       lambda: scaling.ntt_rank(mesh, SCALING_NTT_LOG, 1,
                                                False), checks)
        want = G1.of_compressed_bytes(golden.result())
        log(f"sharded c = {DRYRUN_C} G1 MSM at 2^{GOLDEN_LOG}: {msm_s:.3f} s "
            f"(first call); equal to golden G1.dot: {got == want}")
        if got != want or again != want:
            raise AssertionError("the sharded c=8 MSM differs from golden")
    log(f"phase wall {time.time() - t_phase:.1f} s")
    return paths


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
    log(f"phase 8: groth16 at 2^{BIG_LOG_CONSTRAINTS}")
    big = f"groth16_2^{BIG_LOG_CONSTRAINTS}"
    paths[big] = groth16_path(dev, BIG_LOG_CONSTRAINTS, sample=True)
    provers.append(big)
    log("phase 9 (a): the engine seam, the suite over TorchEngine")
    paths["engine_suite"] = engine_suite_path(dev)
    log(f"phase 9 (b): groth16 over TorchEngine at 2^{ENGINE_LOG}")
    eng16 = f"engine_groth16_2^{ENGINE_LOG}"
    paths[eng16] = engine_groth16_path(dev, ENGINE_LOG)
    provers.append(eng16)
    log(f"phase 10 (a): the witness evaluator, {WITNESS_LANES} lanes x "
        f"{WITNESS_LEVELS} levels")
    paths[f"witness_wide_{WITNESS_LANES}x{WITNESS_LEVELS}"] = \
        witness_wide_path(dev)
    log("phase 10 (b): the witness evaluator over the suite")
    paths["witness_suite"] = witness_suite_path(dev)
    log(f"phase 10 (c): the FFT API at 2^{FFT_LOG}")
    paths[f"fft_2^{FFT_LOG}"] = fft_path(dev)
    log(f"phase 10 (d): bench_msm at 2^{MSM_BENCH_LOG}")
    paths[f"bench_msm_2^{MSM_BENCH_LOG}"] = bench_msm_path(dev)
    log("phase 11: the sharded paths (parallel/), a world of one NCCL rank")
    sharded = sharded_paths(dev)
    paths.update(sharded)
    provers += [p for p, (_c, per) in sharded.items() if per is not None]

    kernels = []
    for name in K.KERNELS:
        source, replaces = REPLACES[name]
        rows = checks[name]
        last = [r for r in rows if "sample" not in r][-1]
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
