"""Build `csrc/*.cu` into one shared library with nvcc and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so it builds in
seconds: one nvcc per source, all started together, then one link.  It
is built at first use into `build/kernels/` beside the package (listed in
.gitignore), keyed by a hash of the sources, and loaded once per process.
Beside the library it writes a report of each source's nvcc seconds and
`-Xptxas -v` output (`report()`, `ptxas_entries()`), kept for later
processes that load the library without building it.  Every C entry
point takes raw device pointers and the CUDA stream as `c_void_p`,
launches on that stream and returns `cudaGetLastError()`; `check` raises
when it is not 0.

There is no fallback: asking for the library where `nvcc` or the card is
missing raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

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


def _compile(src: str, obj: str, flags: List[str]):
    """One nvcc; -> (returncode, output, seconds)."""
    t0 = time.time()
    res = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj,
                          src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    return res.returncode, res.stdout, time.time() - t0


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
        srcs = _sources()
        objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
                for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            done = list(pool.map(lambda so: _compile(*so, FLAGS),
                                 zip(srcs, objs)))
        with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
            f.write("".join(log for _rc, log, _s in done))
        failed = [log for rc, log, _s in done if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(failed)[-8000:])
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
                              *objs], capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr[-8000:])
        build_seconds = time.time() - t0
        rep = {os.path.basename(src): {"nvcc_s": sec, "ptxas": log}
               for src, (_rc, log, sec) in zip(srcs, done)}
        with open(_report_path(out), "w") as f:
            json.dump(rep, f)
        os.replace(tmp, out)
    _lib = ctypes.CDLL(out)
    return _lib


def _report_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".json"


def report() -> Dict[str, dict]:
    """{source file: {"nvcc_s": seconds, "ptxas": -Xptxas -v output}} of
    the build of the loaded library (built by this process or an earlier
    one).  The sources compile all at once, so "nvcc_s" is contended
    wall time; `lone_nvcc_seconds` times one source alone."""
    library()
    path = _report_path(os.path.join(BUILD_DIR,
                                     f"libzk_kernels_{_digest()}.so"))
    with open(path) as f:
        return json.load(f)


def lone_nvcc_seconds(source: str) -> float:
    """Wall seconds of one nvcc of csrc/`source` run alone, with the
    library's flags, into a scratch object that is then removed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    obj = os.path.join(BUILD_DIR, f"{source}.lone{os.getpid()}.o")
    try:
        rc, out, sec = _compile(os.path.join(CSRC, source), obj, FLAGS)
    finally:
        if os.path.exists(obj):
            os.remove(obj)
    if rc != 0:
        raise RuntimeError(f"nvcc of {source} failed:\n" + out[-8000:])
    return sec


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS_FOR = re.compile(r"Function properties for (\S+)")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores")
_REGS = re.compile(r"Used (\d+) registers")
_COMPILE = re.compile(r"Compile time = ([\d.]+) ms")


def ptxas_entries(source: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "stack_bytes", "spill_bytes",
    and "ptxas_ms" where ptxas reports its compile time}} of one source's
    kernels, read from its ptxas report."""
    entries, entry, props, last = {}, None, None, None
    for line in report()[source]["ptxas"].splitlines():
        m = _ENTRY.search(line) or _PROPS_FOR.search(line)
        if m:
            if m.re is _ENTRY:
                entry = m.group(1)
                entries[entry] = {}
            props = m.group(1)
            continue
        m = _PROPS.search(line)
        if m and props in entries:
            entries[props]["stack_bytes"] = int(m.group(1))
            entries[props]["spill_bytes"] = int(m.group(2))
            continue
        m = _REGS.search(line)
        if m and entry is not None:
            entries[entry]["registers"] = int(m.group(1))
            last, entry = entry, None
            continue
        m = _COMPILE.search(line)
        if m and last is not None:
            entries[last]["ptxas_ms"] = float(m.group(1))
            last = None
    return entries


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
