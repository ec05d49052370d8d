"""K4 `digit_sort` and K6 `weighted_chunk_sums` timed at the provers' shapes.

    python -m zukelang_tpu_torch.profile_kernels

K4 on the digit blocks of the provers' MSM batches (rows = windows, each
2^16 digits below nb = 4097: Groth16 G1 and G2, Pinocchio ZK G1 and G2),
on one 2^18 window (nb = 8193, the window profile) and on the 2^20
batch (c = 16, nb = 32769), each beside the stable `torch.sort`; K6 at
the chunk counts of the three levels of `msm._wreduce_batched` (K = 32)
in each group of the Groth16 2^16 and Pinocchio ZK 2^14 proves.  Inputs
are made on the card from a seed: uniform digits, and points with random
coordinates below p.  Times: `timing.time_ms`, minimum of `--reps` after
a warm-up, and the device time of one call (`torch.profiler`); with
`--sweep`, K6 at every group width.  Also the registers and stack of
both sources' kernels (`build.ptxas_entries`).  It calls only the wrappers' public signatures,
so the same file times an earlier tree's kernels.  Needs a CUDA device;
prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import build
from .ops import kernels as K
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="time K6 at every group width g, not only the "
                         "wrapper's choice")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    build.library()

    sorts = []
    for label, rows, logn, nkeys in SORT_SHAPES:
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
    for prover, group, levels in WSUM_LEVELS:
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

    res = {"card": torch.cuda.get_device_name(0), "digit_sort": sorts,
           "weighted_chunk_sums": wsums,
           "ptxas": {src: build.ptxas_entries(src)
                     for src in ("digit_sort.cu", "weighted_sums.cu")}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
