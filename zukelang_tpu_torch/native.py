"""The port's host pairing library: `hostsrc/zukelang_native.cpp`.

Built with the host C++ compiler at first use into `build/native/` beside
the package (listed in .gitignore), keyed by a hash of the source, the
flags and the host CPU (the build uses -march=native), and loaded once
per process with ctypes, the way `build.py` builds the CUDA kernels.  It
is never loaded from anywhere else.

There is no fallback: when the compiler is missing, the build fails or
the library does not load, `library()` raises.  The golden pairing is
taken only where a caller asks for it (`pairing.pairing(..., backend=
"golden")`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time

from .golden.curve import GT
from .golden.field import Fq2, Fq6, Fq12

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "hostsrc", "zukelang_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
# The JAX package's flags.  -march=native ties the library to the host's
# CPU, so the CPU's identity is part of the key (`_digest`).
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lib = None
build_seconds = None   # wall time of this process's build (None: not built)


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what -march=native
    resolves from); the machine name where /proc/cpuinfo is missing."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return platform.machine().encode()
    keys = (b"vendor_id", b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(ln for ln in lines if ln.split(b":")[0].strip() in keys)


def _digest() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_identity())
    return h.hexdigest()[:16]


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler (g++, c++ or clang++; or set CXX): "
                       "the native pairing cannot be built")


def library() -> ctypes.CDLL:
    """The pairing library, built on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libzk_native_{_digest()}.so")
    if not os.path.exists(out):
        t0 = time.time()
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("native pairing build failed:\n"
                               + res.stderr[-8000:])
        os.replace(tmp, out)
        build_seconds = time.time() - t0
    lib = ctypes.CDLL(out)
    lib.native_abi_version.argtypes = []
    lib.native_abi_version.restype = ctypes.c_int
    if lib.native_abi_version() != 1:
        raise RuntimeError(f"{out}: unexpected ABI version")
    lib.gt_multi_pairing.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_char_p]
    lib.gt_multi_pairing.restype = None
    _lib = lib
    return _lib


def gt_multi_pairing(pairs) -> GT:
    """prod_i e(P_i, Q_i) through the C++ tower, with one shared final
    exponentiation."""
    lib = library()
    n = len(pairs)
    g1b = bytearray(96 * n)
    g1i = bytearray(n)
    g2b = bytearray(192 * n)
    g2i = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        if p.is_zero():
            g1i[i] = 1
        else:
            g1b[i * 96:i * 96 + 48] = p.x.n.to_bytes(48, "little")
            g1b[i * 96 + 48:i * 96 + 96] = p.y.n.to_bytes(48, "little")
        if q.is_zero():
            g2i[i] = 1
        else:
            o = i * 192
            for k, v in enumerate((q.x.c0, q.x.c1, q.y.c0, q.y.c1)):
                g2b[o + 48 * k:o + 48 * (k + 1)] = v.n.to_bytes(48, "little")
    out = ctypes.create_string_buffer(576)
    lib.gt_multi_pairing(bytes(g1b), bytes(g1i), bytes(g2b), bytes(g2i), n,
                         out)
    raw = out.raw
    vals = [int.from_bytes(raw[i * 48:(i + 1) * 48], "little")
            for i in range(12)]
    f2 = [Fq2.of_ints(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return GT(Fq12(Fq6(f2[0], f2[1], f2[2]), Fq6(f2[3], f2[4], f2[5])))
