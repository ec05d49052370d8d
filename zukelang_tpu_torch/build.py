"""Build `csrc/*.cu` into one shared library with nvcc and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so it builds in
seconds: one nvcc per source, all started together, then one link.  It
is built at first use into `build/kernels/` beside the package (listed in
.gitignore), keyed by a hash of the sources, and loaded once per process.  Every C entry point takes raw device pointers
and the CUDA stream as `c_void_p`, launches on that stream and returns
`cudaGetLastError()`; `check` raises when it is not 0.

There is no fallback: asking for the library where `nvcc` or the card is
missing raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
build_seconds = None   # wall time of this process's build (None: not built)


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels requested but no CUDA device is "
                           "available")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libzk_kernels_{_digest()}.so")
    if not os.path.exists(out):
        t0 = time.time()
        tag = f"{_digest()}.{os.getpid()}"
        flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
        objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
                for src in _sources()]
        procs = [subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
            f.write("".join(logs))
        failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(failed)[-8000:])
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
                              *objs], capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr[-8000:])
        os.replace(tmp, out)
        build_seconds = time.time() - t0
    _lib = ctypes.CDLL(out)
    return _lib


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
