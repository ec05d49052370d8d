"""K4, K6, K7, K2's add, K3, the NTT and the MSM stages of K2's doubling
and K5, timed at the provers' shapes.

    python -m zukelang_tpu_torch.profile_kernels [--sweep]

K4 on the digit blocks of the provers' MSM batches (rows = windows, each
2^16 digits below nb = 4097: Groth16 G1 and G2, Pinocchio ZK G1 and G2),
on one 2^18 window (nb = 8193, the window profile) and on the 2^20
batch (c = 16, nb = 32769), each beside the stable `torch.sort`; K6 at
the chunk counts of the three levels of `msm._wreduce_batched` (K = 32)
in each group of the Groth16 2^16 and Pinocchio ZK 2^14 proves.  Then
the two MSM stages around K2's doubling and K5 at the same provers'
shapes (c = 13, 20 windows an MSM, 2^16 points a table): the window
combine `msm._combine_windows` and the bucket phase `msm._window_v2`
(K4, K5), each with its device time, the device time of its row
gathers (`index` kernels), its kernel launches and the peak of memory it
allocates; and K5 on the bucket phase's own inputs beside the same call
with its rows in order (`row_orders`), which tells the gather's cost from
the arithmetic's.  K7 at the first two levels of each group's carry
scan in a Groth16 2^16 and a Pinocchio ZK 2^14 prove (K = 32, sorted
segments); K2's add at the widths of a Groth16 2^16 prove's adds (5 to
327,760 points), with the Hillis-Steele scan (`msm._hs_segmented_scan`)
up to 256 points; K3 as the stages that run it (`msm._fixed_base_madd`
on a keygen's 16-element batch, `msm._madd_chunk_scan` on 2^18 points);
the four NTT forms on one 2^16 and one 2^20 vector, and the witness
reduction of `make_synthetic_r1cs(16, seed=1)`, each with its device
time and launches.  Inputs are made on the card from a seed: uniform
digits, points with random coordinates below p, field elements below r.
Times: `timing.time_ms`, minimum of `--reps` after a warm-up, and the
device time of one call (`torch.profiler`); with `--sweep`, K6 and K7 at
every group width and K2's add and its small scan at every lane width.
Also the latency of one dependent Fq product (`kernels.fq_mul_chain`),
from which the adds', K3's, K8's and the window combine's chain bounds,
and the registers and stack of the sources' kernels
(`build.ptxas_entries`).  K8 on the window path's own inputs (2^18 G1
points sorted by their window-3 digits below 8193, K = 32) and at
`chip_smoke.py`'s shape (2^16 G1 and G2, a restart at about half the
steps), with its chain bound, and with `--sweep` at every group width g,
on all-restart segments (every step a restart: K8's loads and stores
without a madd), and for G1 also in place beside the staged form; the
looped Montgomery product at Fq (12, 2^20) beside K1, and the SASS
instructions of both (`probe_looped.sass_figures`).  `--k8-looped-only`
runs these two and the product latency alone.
It calls only functions whose signatures an earlier tree shares (the
wrappers' public signatures, `_combine_windows`, `_window_v2`,
`_hs_segmented_scan`, `_fixed_base_madd`, `_madd_chunk_scan`,
`run_witness_reduction`; the lane sweeps and the product latency only
where the tree has them), so the same file times an earlier tree's
kernels.  Needs a CUDA device; prints one JSON object as its last line,
with the card's name and power limit (`card_line`).
"""

from __future__ import annotations

import argparse
import inspect
import json

import torch

from . import bench_lib, build, probe_looped, profile_msm
from .engine import torch_engine as te
from .ops import kernels as K
from .ops import msm, ntt
from .timing import card_line, time_ms

# (label, rows, log2 n, nkeys)
SORT_SHAPES = (
    ("groth16 G1", 80, 16, 4097), ("groth16 G2", 20, 16, 4097),
    ("pinocchio_zk G1", 160, 16, 4097), ("pinocchio_zk G2", 40, 16, 4097),
    ("window 2^18", 1, 18, 8193), ("groth16_2^20 G1", 64, 20, 32769),
)
# (prover, group, chunks of K = 32 at levels 1, 2, 3 ...)
WSUM_LEVELS = (
    ("groth16", "g1", (10320, 800, 320)), ("groth16", "g2", (2580, 200, 80)),
    ("pinocchio_zk", "g1", (20640, 1600, 640)),
    ("pinocchio_zk", "g2", (5160, 400, 160)),
    ("groth16_2^20", "g2", (16400, 1056, 128)),
)
# (prover, group, tables, the table of each MSM): the MSM batches of one
# prove, 2^16 points a table, c = 13 (20 windows an MSM)
STAGE_BATCHES = (
    ("groth16", "g1", 3, (0, 0, 1, 2)), ("groth16", "g2", 1, (0,)),
    ("pinocchio_zk", "g1", 8, tuple(range(8))),
    ("pinocchio_zk", "g2", 2, (0, 1)),
)
STAGE_LOG, STAGE_C = 16, 13
# (prover, group, points) of K7's first two calls in each group of a
# prove (K = 32, seg); for G2 also the 2^20 prove's first and keygen's
# table scan (2^16 points a window x 16)
SCAN_SHAPES = (
    ("groth16", "g1", 163840), ("groth16", "g1", 5120),
    ("groth16", "g2", 40960), ("groth16", "g2", 1280),
    ("pinocchio_zk", "g1", 327680), ("pinocchio_zk", "g1", 10240),
    ("pinocchio_zk", "g2", 81920), ("pinocchio_zk", "g2", 2560),
    ("groth16_2^20", "g2", 524288), ("keygen", "g2", 1 << 20),
)
NTT_LOGS = (16, 20)
# (group, points) of K2's add a Groth16 2^16 prove makes: the
# Hillis-Steele tails and window combines (up to 256 points: the small
# scan, `msm._hs_segmented_scan`), the weighted reduction's adds (160,
# 80 / 40, 20) and the carry adds (the rest); and a Pinocchio ZK 2^14
# prove's other scan widths (G1 10, G2 80)
ADD_WIDTHS = (("g1", 5), ("g1", 10), ("g1", 80), ("g1", 160), ("g1", 5120),
              ("g1", 163840), ("g1", 327760), ("g2", 20), ("g2", 40),
              ("g2", 80), ("g2", 1280), ("g2", 40960), ("g2", 81940))
# K3's chain: a keygen's small fixed-base batch (16 elements, c = 16, 16
# windows) and the window program's chunked phase 1 (2^18 points, K = 32)
CHAIN_LANES, CHAIN_C = 16, 16
# lengths of the two chains of dependent Fq products whose difference
# times one product (`fq_product_us`)
FQ_CHAIN_REPS = (1000, 101000)
PHASE1_LOG = 18
# K8: (label, group, log2 n, inputs): the window path's own (window 3 of
# profile_msm's 2^18 bases, c = 14), or chip_smoke's coin-flip restarts;
# K = 32
K8_SHAPES = (("window 2^18", "g1", 18, "path"),
             ("chip_smoke 2^16", "g1", 16, "coin"),
             ("chip_smoke 2^16", "g2", 16, "coin"))
K8_K = 32
K8_C = 14
LOOPED_LOG = 20
_FQ_TOP = 0x1a0111ea   # top 32-bit limb of p: smaller top limbs are below p


def _coord(group: str, n: int, gen: torch.Generator, dev) -> torch.Tensor:
    shape = (2, 12, n) if group == "g2" else (12, n)
    c = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                      dtype=torch.int64, device=dev).to(torch.int32)
    c[..., 11, :] = torch.randint(0, _FQ_TOP, c[..., 11, :].shape,
                                  generator=gen, device=dev).to(torch.int32)
    return c


def _device_ms(fn) -> float:
    """Device time of one call of `fn` (the sum of its kernels, copies and
    fills, from `torch.profiler`), apart from the host's launch time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _device_profile(fn):
    """(device ms, device ms of the `index` (gather) kernels, kernel
    launches) of one call of `fn`, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    total = sum(e.self_device_time_total for e in dev_events) / 1e3
    gather = sum(e.self_device_time_total for e in dev_events
                 if "index" in e.key.lower()) / 1e3
    return total, gather, launches


def _peak_mb(fn) -> float:
    """MB allocated by one call of `fn` above what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def row_orders(idx: torch.Tensor, n_rows: int) -> dict:
    """K5 row index arrays of one shape that differ only in where the rows
    lie: the MSM's own (`prove`: sorted by digit, so neighbouring steps and
    lanes read scattered rows), the same rows sorted within each block row
    (`sorted`: a lane's K steps read nearby rows), and rows in order
    (`arange`: lane l reads rows l K .. l K + K - 1 of the table)."""
    seq = torch.arange(idx.numel(), dtype=torch.int64, device=idx.device)
    return {"prove": idx, "sorted": torch.sort(idx, dim=-1).values,
            "arange": (seq % n_rows).to(torch.int32).reshape(idx.shape)}


def k5_row_orders(run, dev, reps: int) -> dict:
    """K5 on the inputs of its call in `run()` (the bucket phase), timed at
    each of `row_orders` with the same segment ids, so the same steps
    continue and only the rows' places (and so the gather) differ:
    {order: {"ms", "device_ms"}}."""
    seen = []
    orig = K.bucket_scan_rows

    def keep(*args, **kwargs):
        seen.append((args, kwargs))
        return orig(*args, **kwargs)
    K.bucket_scan_rows = keep
    try:
        run()
    finally:
        K.bucket_scan_rows = orig
    (rows, idx, seg, kc, group, *rest), kwargs = seen[0]
    out = {}
    for order, ix in row_orders(idx, rows.shape[0]).items():
        def fn():
            return K.bucket_scan_rows(rows, ix, seg, kc, group, *rest,
                                      **kwargs)
        out[order] = {"ms": time_ms(fn, dev, reps)[0],
                      "device_ms": _device_ms(fn)}
    return out


def msm_stages(gen, dev, reps: int):
    """The window combine and the bucket phase of each MSM batch of the
    provers (`STAGE_BATCHES`), timed as one call each."""
    n, c = 1 << STAGE_LOG, STAGE_C
    W = -(-256 // c)
    half = 1 << (c - 1)
    rows = []
    for prover, group, tables, pmap in STAGE_BATCHES:
        BW = W * len(pmap)
        aff = [tuple(_coord(group, n, gen, dev) for _ in range(2))
               for _ in range(tables)]
        precs = torch.cat([msm._prep_rows(t) for t in aff], dim=0)
        dig = (torch.randint(0, 2 * half, (BW, n), generator=gen,
                             dtype=torch.int32, device=dev) - (half - 1))
        bases = torch.repeat_interleave(torch.tensor(
            [p * 2 * n for p in pmap], dtype=torch.int64, device=dev), W)
        stacked = tuple(_coord(group, BW, gen, dev) for _ in range(3))
        row = {"prover": prover, "group": group, "windows": BW, "n": n,
               "c": c}
        for name, fn in (
                ("combine", lambda: msm._combine_windows(stacked, c, W,
                                                         len(pmap))),
                ("window_v2", lambda: msm._window_v2(precs, dig, bases, c,
                                                     group))):
            ms, _ = time_ms(fn, dev, reps)
            dev_ms, gather_ms, launches = _device_profile(fn)
            row[name] = {"ms": ms, "device_ms": dev_ms,
                         "gather_device_ms": gather_ms,
                         "launches": launches, "peak_mb": _peak_mb(fn)}
        if "idx" in inspect.signature(K.bucket_scan_rows).parameters:
            row["k5_by_row_order"] = k5_row_orders(
                lambda: msm._window_v2(precs, dig, bases, c, group), dev,
                reps)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del precs, dig, aff
    return rows


def jac_scans(gen, dev, reps: int, sweep: bool):
    """K7 at `SCAN_SHAPES` with sorted random segments."""
    rows = []
    for prover, group, n in SCAN_SHAPES:
        P = tuple(_coord(group, n, gen, dev) for _ in range(3))
        Z = P[2].reshape(-1, n)
        Z[:, ::17] = 0                                 # infinities
        seg = torch.cumsum(torch.randint(0, 2, (n,), generator=gen,
                                         device=dev), 0).to(torch.int32)
        ms, _ = time_ms(lambda: K.jac_scan(P, 32, seg), dev, reps)
        g = (K.jac_scan_group(n // 32, 32, group)
             if hasattr(K, "jac_scan_group") else 1)
        row = {"prover": prover, "group": group, "points": n,
               "chunks": n // 32, "g": g,
               "ms": ms, "device_ms": _device_ms(lambda: K.jac_scan(P, 32,
                                                                   seg))}
        if sweep:
            row["ms_by_g"] = {w: time_ms(lambda: K.jac_scan(P, 32, seg, w),
                                         dev, reps)[0]
                              for w in (1, 2, 4, 8, 16, 32)
                              if w <= K.max_group(group)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# Dependent Fq products a prove's window combine chains: window 19 of 20
# doubled 13 x 19 times, 3 products a doubling (point_ops.cu, G1 and G2)
COMBINE_CHAIN = 13 * 19 * 3


def fq_product_us(gen, dev, reps: int) -> dict:
    """The latency of one bare dependent Fq product on the card
    (`kernels.fq_mul_chain`, one thread): the difference of chains of
    FQ_CHAIN_REPS[1] and [0] products over the difference of their
    lengths, so the launch cancels out.  A G2 formula's Fq products
    (three an Fq2 product, two a square) are the same product, so one
    latency serves both groups.  With it the window combine's chain
    bound (COMBINE_CHAIN products)."""
    if not hasattr(K, "fq_mul_chain"):
        return {}
    a, b = _coord("g1", 1, gen, dev), _coord("g1", 1, gen, dev)
    lo, hi = (time_ms(lambda: K.fq_mul_chain(a, b, r), dev, reps)[0]
              for r in FQ_CHAIN_REPS)
    us = (hi - lo) * 1e3 / (FQ_CHAIN_REPS[1] - FQ_CHAIN_REPS[0])
    return {"fq_mul_us": us,
            "combine_chain_bound_ms": _chain_bound_ms(COMBINE_CHAIN, us)}


def _by_lanes(group: str, fn, dev, reps: int):
    """({L: ms}, {L: device ms}) of fn(L) at every lane width of K2's add:
    `time_ms`, and the device time of one call."""
    ms, dev_ms = {}, {}
    for L in K.POINT_LANES[group]:
        ms[L] = time_ms(lambda: fn(L), dev, reps)[0]
        dev_ms[L] = _device_ms(lambda: fn(L))
    return ms, dev_ms


def _chain_bound_ms(chain_products: float, us: float) -> float:
    return chain_products * us / 1e3


def point_adds(gen, dev, reps: int, sweep: bool, fq_us: dict = None):
    """K2's add at `ADD_WIDTHS` on random points (every 17th at infinity):
    the plain form, and up to 256 points the Hillis-Steele scan
    (`msm._hs_segmented_scan`) in segments of 20 points, as a prove's
    window combine sums each MSM's 20 windows; with `sweep`, at
    every lane width the source builds.  With the product latency fq_us,
    each row's chain bound: the dependent Fq products of one add at the
    chosen width (of the scan's rounds and passes) x that latency."""
    lanes_of = getattr(K, "point_lanes", None)
    rows = []
    for group, n in ADD_WIDTHS:
        P, Q = (tuple(_coord(group, n, gen, dev) for _ in range(3))
                for _ in range(2))
        P[2].reshape(-1, n)[:, ::17] = 0
        row = {"group": group, "points": n,
               "lanes": lanes_of(group, n) if lanes_of else 1,
               "add_ms": time_ms(lambda: K.point_add(P, Q), dev, reps)[0],
               "add_device_ms": _device_ms(lambda: K.point_add(P, Q))}
        if fq_us and lanes_of:
            row["add_chain_bound_ms"] = _chain_bound_ms(
                K.POINT_CHAIN["add"][group][row["lanes"]],
                fq_us["fq_mul_us"])
        if sweep and lanes_of:
            row["add_ms_by_lanes"], row["add_device_ms_by_lanes"] = (
                _by_lanes(group, lambda L: K.point_add(P, Q, L), dev, reps))
        if n <= 256:
            seg = torch.arange(n, dtype=torch.int32, device=dev) // 20
            fn = lambda: msm._hs_segmented_scan(P, seg)   # noqa: E731
            row["scan_ms"] = time_ms(fn, dev, reps)[0]
            row["scan_device_ms"], _g, row["scan_launches"] = (
                _device_profile(fn))
            if fq_us and lanes_of:
                L = K.point_lanes(group, n, "scan")
                per_block = 32 * K.SEG_SCAN_SMALL_WARPS // L
                row["scan_lanes"] = L
                row["scan_chain_bound_ms"] = _chain_bound_ms(
                    max(1, (n - 1).bit_length()) * -(-n // per_block)
                    * K.POINT_CHAIN["add"][group][L], fq_us["fq_mul_us"])
            if sweep and lanes_of:
                row["scan_ms_by_lanes"], row["scan_device_ms_by_lanes"] = (
                    _by_lanes(group, lambda L: K.seg_scan_small(P, seg, L),
                              dev, reps))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def madd_chains(gen, dev, reps: int, fq_us: dict = None):
    """K3 on its two paths, timed as the stages that call it (the same
    functions in an earlier tree, where they loop one K3 launch a step):
    a keygen's small fixed-base batch (`msm._fixed_base_madd`, random
    table of 16 windows of 2^16 entries, 16 lanes) and the chunked phase
    1 (`msm._madd_chunk_scan`, 2^18 random affine points, sorted random
    digits below 8193); with fq_us, the chain bound (steps - 1 mixed adds
    of the chain's dependent Fq products x the product latency)."""
    rows = []
    chain = getattr(K, "point_madd_chain", None)
    for group in ("g1", "g2"):
        W = -(-256 // CHAIN_C)
        T = W << CHAIN_C
        tX, tY = _coord(group, T, gen, dev), _coord(group, T, gen, dev)
        dig = torch.randint(0, 1 << CHAIN_C, (W, CHAIN_LANES), generator=gen,
                            dtype=torch.int32, device=dev)
        n = 1 << PHASE1_LOG
        X, Y = _coord(group, n, gen, dev), _coord(group, n, gen, dev)
        d = torch.sort(torch.randint(0, 8193, (n,), generator=gen,
                                     device=dev))[0].to(torch.int32)
        for stage, fn, lanes, kw in (
                ("fixed_base", lambda: msm._fixed_base_madd(tX, tY, dig,
                                                            CHAIN_C),
                 CHAIN_LANES, dict(table=(tX, tY), steps=W, digits=dig,
                                   c=CHAIN_C)),
                ("phase1", lambda: msm._madd_chunk_scan((X, Y), d, 32),
                 n // 32, dict(table=(X, Y), steps=32, seg=d, keep=True))):
            dev_ms, _g, launches = _device_profile(fn)
            row = {"group": group, "stage": stage, "lanes": lanes,
                   "steps": kw["steps"], "ms": time_ms(fn, dev, reps)[0],
                   "device_ms": dev_ms, "launches": launches}
            if chain is not None:
                row["lanes_a_point"] = K.MADD_CHAIN_LANES[group]
                if fq_us:
                    row["chain_bound_ms"] = _chain_bound_ms(
                        (kw["steps"] - 1) * K.POINT_CHAIN["madd"][group],
                        fq_us["fq_mul_us"])
            rows.append(row)
            print(json.dumps(row), flush=True)
        del tX, tY, X, Y
    return rows


def _k8_chain_products(K_: int, g: int, group: str) -> int:
    """Fq products on the dependent chain of one K8 chunk at g lanes: 11
    a mixed add, 16 a full add (x3 for G2, three Fq products an Fq2
    product)."""
    L = K_ // g
    madds, adds = (K_ - 1, 0) if g == 1 else (2 * L - 1, g.bit_length() - 1)
    return (11 * madds + 16 * adds) * (3 if group == "g2" else 1)


def _k8_inputs(group: str, logn: int, kind: str, gen, dev):
    """(points, seg) of a `K8_SHAPES` row: the window path's own sorted
    points and digits (`profile_msm`'s window of its 2^logn bases k G),
    or random affine points (every 13th at infinity) under coin-flip
    restarts."""
    n = 1 << logn
    if kind == "path":
        Paff, S, _scalars, _ks = profile_msm.make_inputs(logn, dev)
        dig = msm._scalars_to_signed_windows(S, K8_C)[
            profile_msm.WINDOW].contiguous()
        pts, absd = msm._apply_signs(Paff, dig)
        seg, order = K.digit_sort(absd.reshape(1, n), msm.n_buckets(K8_C))
        order = order[0].to(torch.int64)
        return tuple(x[..., order].contiguous() for x in pts), seg[0]
    P = (_coord(group, n, gen, dev), _coord(group, n, gen, dev))
    for x in P:
        x.reshape(-1, n)[:, ::13] = 0
    seg = torch.cumsum(torch.randint(0, 2, (n,), generator=gen, device=dev),
                       0)
    return P, seg.to(torch.int32)


def k8_scans(gen, dev, reps: int, sweep: bool, fq_us: dict = None):
    """K8 at `K8_SHAPES`: time and device time at the wrapper's g and,
    with fq_us, its chain bound; with `sweep`, at every g (dividing K),
    also on all-restart segments (no madd: K8's loads and stores alone),
    and for G1 the same in place (`in_place=True`; the wrapper stages a
    block's columns in shared memory from g = 4 at K = 32), its words
    held equal to the staged form's."""
    widths = getattr(K, "bscan_group", None)
    forms = "in_place" in inspect.signature(K.bucket_scan).parameters
    rows = []
    for label, group, logn, kind in K8_SHAPES:
        n = 1 << logn
        P, seg = _k8_inputs(group, logn, kind, gen, dev)
        g = widths(n // K8_K, K8_K, group) if widths else 1

        def run(w=None, s=seg, **kw):
            return (K.bucket_scan(P, s, K8_K, group, w, **kw) if widths
                    else K.bucket_scan(P, s, K8_K, group))
        row = {"shape": label, "group": group, "points": n,
               "chunks": n // K8_K, "g": g,
               "ms": time_ms(run, dev, reps)[0],
               "device_ms": _device_ms(run)}
        if fq_us:
            row["chain_bound_ms"] = _chain_bound_ms(
                _k8_chain_products(K8_K, g, group), fq_us["fq_mul_us"])
        if sweep and widths:
            gs = [w for w in (1, 2, 4, 8, 16, 32) if K8_K % w == 0]
            every = torch.arange(n, dtype=torch.int32, device=dev)
            row["ms_by_g"] = {w: time_ms(lambda: run(w), dev, reps)[0]
                              for w in gs}
            row["device_ms_by_g"] = {w: _device_ms(lambda: run(w))
                                     for w in gs}
            row["all_restart_device_ms_by_g"] = {
                w: _device_ms(lambda: run(w, every)) for w in gs}
            if forms and group == "g1":
                for w in gs:
                    a, b = run(w), run(w, in_place=True)
                    if not (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                            and torch.equal(a[1], b[1])):
                        raise AssertionError(f"K8 g = {w}: the staged and "
                                             "the in-place forms differ")
                row["in_place_ms_by_g"] = {
                    w: time_ms(lambda: run(w, in_place=True), dev, reps)[0]
                    for w in gs}
                row["in_place_all_restart_device_ms_by_g"] = {
                    w: _device_ms(lambda: run(w, every, in_place=True))
                    for w in gs}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del P, seg
    return rows


def looped_product(gen, dev, reps: int):
    """The looped product at Fq (12, 2^LOOPED_LOG) beside K1 (time and
    device time), its output held equal to K1's; and the SASS
    instructions of both kernels."""
    from .params import FQ
    n = 1 << LOOPED_LOG
    a, b = (_coord("g1", n, gen, dev) for _ in range(2))
    if not torch.equal(K.mont_mul_looped(a, b, FQ), K.mont_mul(a, b, FQ)):
        raise AssertionError("mont_mul_looped differs from K1")
    row = {"field": "Fq", "n": n,
           "k1_ms": time_ms(lambda: K.mont_mul(a, b, FQ), dev, reps)[0],
           "k1_device_ms": _device_ms(lambda: K.mont_mul(a, b, FQ)),
           "ms": time_ms(lambda: K.mont_mul_looped(a, b, FQ), dev, reps)[0],
           "device_ms": _device_ms(lambda: K.mont_mul_looped(a, b, FQ))}
    if hasattr(probe_looped, "sass_figures"):
        row["sass"] = probe_looped.sass_figures()
    print(json.dumps(row), flush=True)
    return row


def ntt_forms(gen, dev, reps: int):
    """The four NTT forms on one vector of each of `NTT_LOGS`, then the
    witness reduction of the Groth16 2^16 prove's circuit."""
    rows = []
    for logn in NTT_LOGS:
        x = torch.randint(-(1 << 31), 1 << 31, (8, 1 << logn), generator=gen,
                          dtype=torch.int64, device=dev).to(torch.int32)
        x[7] = torch.randint(0, 0x73eda753, (1 << logn,), generator=gen,
                             device=dev).to(torch.int32)
        for form in ("ntt", "intt", "coset_ntt", "coset_intt"):
            fn = getattr(ntt, form)
            dev_ms, _g, launches = _device_profile(lambda: fn(x))
            rows.append({"form": form, "logn": logn,
                         "ms": time_ms(lambda: fn(x), dev, reps)[0],
                         "device_ms": dev_ms, "launches": launches})
            print(json.dumps(rows[-1]), flush=True)
    inst = bench_lib.make_synthetic_r1cs(16, seed=1)
    wm = inst.pack_witness(dev)
    dev_ms, _g, launches = _device_profile(
        lambda: te.run_witness_reduction(inst.fc, wm))
    rows.append({"form": "witness_reduction", "logn": inst.fc.logn,
                 "ms": time_ms(lambda: te.run_witness_reduction(inst.fc, wm),
                               dev, reps)[0],
                 "device_ms": dev_ms, "launches": launches})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="time K6 and K7 at every group width g, and K2's "
                         "add and its small scan at every lane width, not "
                         "only the wrapper's choice")
    ap.add_argument("--stages-only", action="store_true",
                    help="only the combine and bucket-phase stages")
    ap.add_argument("--points-only", action="store_true",
                    help="only the Fq product latency, K2's add and K3's "
                         "chain")
    ap.add_argument("--k8-looped-only", action="store_true",
                    help="only the Fq product latency, K8 and the looped "
                         "product")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    build.library()

    others = not (args.stages_only or args.points_only
                  or args.k8_looped_only)
    sorts = []
    for label, rows, logn, nkeys in (SORT_SHAPES if others else ()):
        keys = torch.randint(0, nkeys, (rows, 1 << logn), generator=gen,
                             dtype=torch.int32, device=dev)
        ms, (sk, order) = time_ms(lambda: K.digit_sort(keys, nkeys), dev,
                                  args.reps)
        lib_ms, (want, worder) = time_ms(
            lambda: torch.sort(keys, dim=-1, stable=True), dev, args.reps)
        equal = torch.equal(sk, want) and torch.equal(order.long(), worder)
        sorts.append({"shape": label, "rows": rows, "n": 1 << logn,
                      "nkeys": nkeys, "ms": ms, "torch_sort_ms": lib_ms,
                      "device_ms": _device_ms(lambda: K.digit_sort(keys,
                                                                   nkeys)),
                      "torch_sort_device_ms": _device_ms(
                          lambda: torch.sort(keys, dim=-1, stable=True)),
                      "equal_to_torch_sort": equal})
        print(json.dumps(sorts[-1]), flush=True)
        del keys, sk, order, want, worder

    wsums = []
    for prover, group, levels in (WSUM_LEVELS if others else ()):
        for level, chunks in enumerate(levels, 1):
            P = tuple(_coord(group, chunks * 32, gen, dev) for _ in range(3))
            ms, _ = time_ms(lambda: K.weighted_chunk_sums(P, 32), dev,
                            args.reps)
            g = (K.wsum_group(chunks, 32, group) if hasattr(K, "wsum_group")
                 else 1)
            row = {"prover": prover, "group": group, "level": level,
                   "chunks": chunks, "g": g, "ms": ms}
            if args.sweep:
                row["ms_by_g"] = {
                    w: time_ms(lambda: K.weighted_chunk_sums(P, 32, w), dev,
                               args.reps)[0] for w in (1, 2, 4, 8, 16, 32)
                    if w <= K.max_group(group)}
            wsums.append(row)
            print(json.dumps(row), flush=True)

    scans = jac_scans(gen, dev, args.reps, args.sweep) if others else []
    points = others or args.points_only
    k8 = others or args.k8_looped_only
    fq_us = (fq_product_us(gen, dev, args.reps) if points or k8 else {})
    adds = (point_adds(gen, dev, args.reps, args.sweep, fq_us) if points
            else [])
    chains = madd_chains(gen, dev, args.reps, fq_us) if points else []
    scans8 = k8_scans(gen, dev, args.reps, args.sweep, fq_us) if k8 else []
    looped = looped_product(gen, dev, args.reps) if k8 else {}
    forms = ntt_forms(gen, dev, args.reps) if others else []
    stages = (msm_stages(gen, dev, args.reps) if others or args.stages_only
              else [])
    res = {"card": torch.cuda.get_device_name(0), "card_line": card_line(),
           "digit_sort": sorts,
           "weighted_chunk_sums": wsums, "jac_scan": scans,
           "fq_product_us": fq_us, "point_add": adds,
           "point_madd_chain": chains, "bucket_scan": scans8,
           "mont_mul_looped": looped, "ntt": forms,
           "msm_stages": stages,
           "ptxas": {src: build.ptxas_entries(src)
                     for src in ("digit_sort.cu", "weighted_sums.cu",
                                 "weighted_sums_g2.cu", "point_ops.cu",
                                 "point_add.cu", "point_madd.cu",
                                 "bucket_scan.cu", "bucket_scan_g2.cu",
                                 "jac_scan.cu", "jac_scan_g2.cu", "ntt.cu",
                                 "mont_mul.cu", "mont_mul_looped.cu")
                     if src in build.report()}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
