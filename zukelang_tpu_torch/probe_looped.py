"""The looped Montgomery product against K1, on the card.

    python -m zukelang_tpu_torch.probe_looped [logN]

Counterpart of the JAX package's `scripts/probe_looped_kernel.py`: a and b
are 2^logN Fq elements (default 2^20) tiled from 256 random Montgomery
values each (`numpy.random.RandomState(3)`); the looped kernel
(`kernels.mont_mul_looped`, the outer limb loop rolled) and K1
(`kernels.mont_mul`, unrolled) are each timed as the best of 5 launches
after a warm-up (`timing.time_ms`, CUDA events), and their outputs must
be identical.  On the TPU the probe's question was compile time against
body size, so it also prints, for each of the two sources, one nvcc run
alone (`build.lone_nvcc_seconds`; the library build compiles every
source at once, so its own nvcc times are contended), and each kernel's
ptxas compile time, registers, stack and spills (`build.ptxas_entries`).

Needs a CUDA device: without one it raises, and never runs on the CPU
instead.  Its last line is one JSON object.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import build, params
from .ops import field as F
from .ops import kernels as K
from .params import FQ
from .timing import time_ms

SOURCES = ("mont_mul.cu", "mont_mul_looped.cu")


def make_inputs(logn: int, dev: torch.device):
    """a, b: (12, 2^logn) Montgomery Fq, each 256 random values tiled."""
    n = 1 << logn
    rng = np.random.RandomState(3)
    vals = [[int.from_bytes(rng.bytes(47), "little") % params.P
             for _ in range(256)] for _ in range(2)]
    return tuple(F.pack_mont(v, FQ, dev).repeat(1, n // 256) for v in vals)


def build_figures() -> dict:
    """{source: {"nvcc_alone_s", "nvcc_in_build_s" (contended),
    "kernels": {name: ptxas ms/registers/stack/spills}}}."""
    rep = build.report()
    return {src: {"nvcc_alone_s": build.lone_nvcc_seconds(src),
                  "nvcc_in_build_s": rep[src]["nvcc_s"],
                  "kernels": build.ptxas_entries(src)} for src in SOURCES}


def run(logn: int, dev: torch.device, log=print):
    """-> (result dict, (a, b, looped output))."""
    n = 1 << logn
    a, b = make_inputs(logn, dev)
    looped_ms, _ = time_ms(lambda: K.mont_mul_looped(a, b, FQ), dev, 5)
    unrolled_ms, _ = time_ms(lambda: K.mont_mul(a, b, FQ), dev, 5)
    out_l = K.mont_mul_looped(a, b, FQ)
    out_u = K.mont_mul(a, b, FQ)
    same = bool(torch.equal(out_l, out_u))
    for name, ms in (("looped CIOS", looped_ms), ("unrolled CIOS (K1)",
                                                  unrolled_ms)):
        log(f"  {name:24s} best {ms:9.4f} ms  ({n / ms / 1e3:.0f} Mmul/s)")
    log(f"  outputs identical: {same}")
    if not same:
        raise AssertionError("probe_looped: the looped product differs "
                             "from K1's")
    res = {"logn": logn, "field": "Fq", "looped_ms": looped_ms,
           "unrolled_ms": unrolled_ms, "identical": same,
           "timing": "min of 5 after a warm-up"}
    if dev.type == "cuda":
        res["build"] = build_figures()
        for src, fig in res["build"].items():
            log(f"  {src}: nvcc alone {fig['nvcc_alone_s']:.2f} s (in the "
                f"parallel build {fig['nvcc_in_build_s']:.2f} s), kernels "
                f"{fig['kernels']}")
        res["device"] = torch.cuda.get_device_name(dev)
    return res, (a, b, out_l)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    logn = int(argv[0]) if argv else 20
    if not torch.cuda.is_available():
        raise SystemExit("probe_looped: needs a CUDA device")
    dev = torch.device("cuda")
    print(f"looped vs unrolled Montgomery product, 2^{logn} Fq elements, on "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    res, _ = run(logn, dev, log=lambda s: print(s, flush=True))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
