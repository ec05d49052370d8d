"""K4, K6, K7, the NTT and the MSM stages of K2's doubling and K5, timed
at the provers' shapes.

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
segments); the four NTT forms on one 2^16 and one 2^20 vector, and the
witness reduction of `make_synthetic_r1cs(16, seed=1)`, each with its
device time and launches.  Inputs are made on the card
from a seed: uniform digits, points with random coordinates below p,
field elements below r.  Times: `timing.time_ms`, minimum of `--reps`
after a warm-up, and the device time of one call (`torch.profiler`);
with `--sweep`, K6 and K7 at every group width.  Also the registers and
stack of the sources' kernels (`build.ptxas_entries`).
It calls only functions whose signatures an earlier tree shares (the
wrappers' public signatures, `_combine_windows`, `_window_v2`,
`run_witness_reduction`), so the same file times an earlier tree's
kernels.  Needs a CUDA device; prints
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import inspect
import json

import torch

from . import bench_lib, build
from .engine import torch_engine as te
from .ops import kernels as K
from .ops import msm, ntt
from .timing import time_ms

# (label, rows, log2 n, nkeys)
SORT_SHAPES = (
    ("groth16 G1", 80, 16, 4097), ("groth16 G2", 20, 16, 4097),
    ("pinocchio_zk G1", 160, 16, 4097), ("pinocchio_zk G2", 40, 16, 4097),
    ("window 2^18", 1, 18, 8193), ("groth16_2^20 G1", 64, 20, 32769),
)
# (prover, group, chunks of K = 32 at levels 1, 2, 3)
WSUM_LEVELS = (
    ("groth16", "g1", (10320, 800, 320)), ("groth16", "g2", (2580, 200, 80)),
    ("pinocchio_zk", "g1", (20640, 1600, 640)),
    ("pinocchio_zk", "g2", (5160, 400, 160)),
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
# prove (K = 32, seg)
SCAN_SHAPES = (
    ("groth16", "g1", 163840), ("groth16", "g1", 5120),
    ("groth16", "g2", 40960), ("groth16", "g2", 1280),
    ("pinocchio_zk", "g1", 327680), ("pinocchio_zk", "g1", 10240),
    ("pinocchio_zk", "g2", 81920), ("pinocchio_zk", "g2", 2560),
)
NTT_LOGS = (16, 20)
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
        g = (K.jac_scan_group(n // 32, 32) if hasattr(K, "jac_scan_group")
             else 1)
        row = {"prover": prover, "group": group, "points": n,
               "chunks": n // 32, "g": g,
               "ms": ms, "device_ms": _device_ms(lambda: K.jac_scan(P, 32,
                                                                   seg))}
        if sweep and g != 1:
            row["ms_by_g"] = {w: time_ms(lambda: K.jac_scan(P, 32, seg, w),
                                         dev, reps)[0]
                              for w in (1, 2, 4, 8, 16, 32)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


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
                    help="time K6 and K7 at every group width g, not only "
                         "the wrapper's choice")
    ap.add_argument("--stages-only", action="store_true",
                    help="only the combine and bucket-phase stages")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    build.library()

    sorts = []
    for label, rows, logn, nkeys in (() if args.stages_only
                                     else SORT_SHAPES):
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
    for prover, group, levels in (() if args.stages_only else WSUM_LEVELS):
        for level, chunks in enumerate(levels, 1):
            P = tuple(_coord(group, chunks * 32, gen, dev) for _ in range(3))
            ms, _ = time_ms(lambda: K.weighted_chunk_sums(P, 32), dev,
                            args.reps)
            g = K.wsum_group(chunks, 32) if hasattr(K, "wsum_group") else 1
            row = {"prover": prover, "group": group, "level": level,
                   "chunks": chunks, "g": g, "ms": ms}
            if args.sweep:
                row["ms_by_g"] = {
                    w: time_ms(lambda: K.weighted_chunk_sums(P, 32, w), dev,
                               args.reps)[0] for w in (1, 2, 4, 8, 16, 32)}
            wsums.append(row)
            print(json.dumps(row), flush=True)

    scans = [] if args.stages_only else jac_scans(gen, dev, args.reps,
                                                  args.sweep)
    forms = [] if args.stages_only else ntt_forms(gen, dev, args.reps)
    stages = msm_stages(gen, dev, args.reps)
    res = {"card": torch.cuda.get_device_name(0), "digit_sort": sorts,
           "weighted_chunk_sums": wsums, "jac_scan": scans, "ntt": forms,
           "msm_stages": stages,
           "ptxas": {src: build.ptxas_entries(src)
                     for src in ("digit_sort.cu", "weighted_sums.cu",
                                 "point_ops.cu", "bucket_scan.cu",
                                 "jac_scan.cu", "ntt.cu")
                     if src in build.report()}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
