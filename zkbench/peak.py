"""The card's peak rate of limb products, measured in the run that reads
`msm_roofline`: `peak/limb_products.cu`, built with nvcc into
`build/zkbench/` inside the checkout (once a checkout; the file name
carries the source's digest) and loaded with ctypes.

A launch keeps every SM full (8 blocks of 256 threads an SM) for some
tens of milliseconds; the rate is the best of several timed launches
after warm-up ones, by CUDA events.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "peak", "limb_products.cu")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build", "zkbench")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
THREADS, BLOCKS_PER_SM, ITERS = 256, 8, 16384
WARMUP, TIMED = 3, 5


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def library() -> ctypes.CDLL:
    """The probe's shared library, built at first use."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"limb_products_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        res = subprocess.run([_nvcc(), *ARCH_FLAGS, "-O3", "-shared",
                              "-Xcompiler", "-fPIC", "-o", tmp, SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.zkbench_limb_products.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    lib.zkbench_limb_products.restype = ctypes.c_int
    lib.zkbench_limb_products_per_thread_step.restype = ctypes.c_int
    return lib


def limb_products_per_s(device) -> float:
    """The best rate of limb products of TIMED launches on `device`."""
    import torch
    lib = library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    products = (blocks * THREADS * ITERS
                * lib.zkbench_limb_products_per_thread_step())
    best = 0.0
    for k in range(WARMUP + TIMED):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        err = lib.zkbench_limb_products(out.data_ptr(), blocks, THREADS,
                                        ITERS, 0x9E3779B9, 0x7F4A7C15,
                                        ctypes.c_void_p(stream.cuda_stream))
        t1.record(stream)
        if err:
            raise RuntimeError(f"limb_products launch failed: CUDA error {err}")
        t1.synchronize()
        if k >= WARMUP:
            best = max(best, products / (t0.elapsed_time(t1) / 1e3))
    return best
