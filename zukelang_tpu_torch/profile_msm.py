"""Where one MSM window's time goes on the card, stage by stage.

    python -m zukelang_tpu_torch.profile_msm [logN] [c]

Counterpart of the JAX package's two MSM profilers (`scripts/profile_msm.py`,
`scripts/profile_msm2.py`), for one G1 window at N = 2^logN (default 18)
with window width c (default `auto_window(N)`, 14 at 2^18).  The bases are
the profilers' own: k*G for random 30-bit k (`fixed_base_mul`, K5 rows),
normalised to affine; the scalars are random below r, both from
`numpy.random.RandomState(11)`.  Window 3 of the signed digits is the
window profiled.

Stages, each timed as the minimum of 3 runs after a warm-up
(`timing.time_ms`: CUDA events around each run, so a stage's host reads
of the card count in its time):
  digit extract (unsigned, signed), the sort three ways (K4 digit_sort,
  torch.sort(stable=True), torch.argsort of the composite key digit << logN
  | index), sign flip, sort + gather, K8 alone, the carry scatter (K7, K2),
  the weighted reduce (K7, K2), phase 1 of the chunked bucket sums (a loop
  of K3), the log-depth carry scan of its chunk tails (K2), the whole
  window program (signed digits, the K8 route), and the whole
  `msm_staged` MSM with its Mterm/s.

The two stages off the window program's route are held against it as
affine points: the buckets of the K3 phase 1 against the K8 route's, the
log-depth carry scan against the K7 route's; a difference raises.

Needs a CUDA device: without one it raises, and never runs on the CPU
instead.  Its last line is one JSON object with the stage times and the
launch counts of one window program.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from . import params
from .ops import curve as C
from .ops import field as F
from .ops import kernels as K
from .ops import msm
from .params import FR
from .timing import time_ms

WINDOW = 3          # the window the JAX profilers take
SEED = 11


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_inputs(logn: int, dev: torch.device, seed: int = SEED):
    """-> (affine bases, (8, N) standard scalars, scalar ints, the bases'
    30-bit multipliers k): base i is k_i * G."""
    n = 1 << logn
    rng = np.random.RandomState(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % params.R
               for _ in range(n)]
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    S = F.pack(scalars, FR, dev)
    P = msm.fixed_base_mul(F.pack(ks, FR, dev), group="g1")
    return C.to_affine(P), S, scalars, ks


def same_points(p: C.Point, q: C.Point) -> bool:
    """The two Jacobian batches hold the same points (compared affine)."""
    return all(torch.equal(a, b)
               for a, b in zip(C.to_affine(p), C.to_affine(q)))


def profile(logn: int, c: int, dev: torch.device, reps: int = 3,
            log=print):
    """Run every stage; -> (result dict, state dict of the inputs, the
    window's sorted points and its stage outputs for a caller's checks).
    The two stages off the window program's route are held against it:
    the K3 route's buckets (`_carry_scatter` of the chunked phase 1)
    against the K8 route's, and the log-depth carry scan of the chunk
    tails against the K7 route's (`_seg_scan_auto`); a difference
    raises."""
    n = 1 << logn
    K8 = msm.CHUNK
    nb = msm.n_buckets(c)
    nb_pad = -(-nb // 64) * 64 if nb >= 128 else nb
    stages = {}

    def stage(name, fn):
        ms, out = time_ms(fn, dev, reps, "min")
        stages[name] = ms
        log(f"  {name:34s} {ms:10.3f} ms")
        return out

    t0 = time.perf_counter()
    Paff, S, scalars, ks = make_inputs(logn, dev)
    _sync(dev)
    point_gen_s = time.perf_counter() - t0
    log(f"  point generation (once)            {point_gen_s:10.3f} s")

    stage("digit_extract_unsigned", lambda: msm._scalars_to_windows(S, c))
    digits = stage("digit_extract_signed",
                   lambda: msm._scalars_to_signed_windows(S, c))
    dig = digits[WINDOW].contiguous()
    absd = dig.abs().reshape(1, n)
    stage("sort_k4_digit_sort", lambda: K.digit_sort(absd, nb))
    stage("sort_torch_sort_stable", lambda: torch.sort(absd[0], stable=True))
    key = (absd[0].to(torch.int64) << logn) | torch.arange(n, device=dev)
    stage("sort_torch_argsort_composite", lambda: torch.argsort(key))
    pts_f, absd2 = stage("sign_flip", lambda: msm._apply_signs(Paff, dig))

    def sort_gather():
        d_sorted, order = K.digit_sort(absd2.reshape(1, n), nb)
        order = order[0].to(torch.int64)
        return tuple(x[..., order] for x in pts_f), d_sorted[0]

    pts_s, d_sorted = stage("sort_gather", sort_gather)
    scanned, collided = stage(
        "k8_bucket_scan", lambda: K.bucket_scan(pts_s, d_sorted, K8, "g1"))
    buckets = stage("carry_scatter", lambda: msm._carry_scatter(
        scanned, d_sorted, nb, K8))
    stage("weighted_reduce", lambda: msm._weighted_bucket_reduce(
        msm._pad_buckets(buckets, nb_pad)))
    ph1 = stage("chunked_phase1_k3",
                lambda: msm._madd_chunk_scan(pts_s, d_sorted, K8))
    tails = tuple(x[..., K8 - 1::K8] for x in ph1)
    last_seg = d_sorted[K8 - 1::K8]
    car_hs = stage("hs_carry_scan",
                   lambda: msm._hs_segmented_scan(tails, last_seg))

    run = msm.window_program("g1", c, affine=True)
    stage("window_program", lambda: run(Paff, dig))
    before = dict(K.LAUNCHES)
    run(Paff, dig)
    _sync(dev)
    window_launches = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS}

    msm_ms, _ = time_ms(lambda: msm.msm_staged(Paff, S, "g1", c), dev,
                        reps, "min")
    stages["msm_staged"] = msm_ms
    n_windows = digits.shape[0]
    log(f"  msm_staged ({n_windows} windows)          {msm_ms:10.3f} ms"
        f"  ({n / msm_ms / 1e3:.3f} Mterm/s)")

    # the stages off the window program's route, against that route
    k8_flagged = bool(collided.any())
    if k8_flagged:
        log("  (K8 flagged a lane: its buckets are taken from the safe route)")
        buckets = msm._bucket_sums_fused(pts_f, absd2, nb)
    car_k7 = msm._seg_scan_auto(tuple(x[..., K8 - 1::K8] for x in scanned),
                                last_seg)
    checks = {
        "k3_route_buckets_equal_k8_route": same_points(
            msm._carry_scatter(ph1, d_sorted, nb, K8), buckets),
        "hs_carry_scan_equal_k7_route": same_points(car_hs, car_k7),
    }
    log(f"  stage checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"profile_msm: stage outputs differ: {checks}")
    result = {
        "logn": logn, "c": c, "n_buckets": nb, "n_windows": n_windows,
        "window": WINDOW, "point_gen_s": point_gen_s, "timing": "min of "
        f"{reps} after a warm-up, CUDA events", "stages_ms": stages,
        "msm_mterms_per_s": n / msm_ms / 1e3,
        "window_program_launches": window_launches,
        "bucket_sums_fused_fallbacks": msm.FALLBACKS["bucket_sums_fused"],
        "k8_flagged": k8_flagged, "stage_checks": checks,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    state = {"points": Paff, "scalars_std": S, "scalars": scalars, "ks": ks,
             "digits": digits, "absd": absd, "pts_sorted": pts_s,
             "d_sorted": d_sorted, "k8_scan": scanned, "ph1": ph1,
             "buckets": buckets, "nb_pad": nb_pad}
    return result, state


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    logn = int(argv[0]) if argv else 18
    c = int(argv[1]) if len(argv) > 1 else msm.auto_window(1 << logn)
    if not torch.cuda.is_available():
        raise SystemExit("profile_msm: needs a CUDA device")
    dev = torch.device("cuda")
    print(f"one G1 window at N = 2^{logn}, c = {c}, on "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    res, _ = profile(logn, c, dev, log=lambda s: print(s, flush=True))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
