"""The port's host library: `hostsrc/zukelang_native.cpp`.

Built with the host C++ compiler at first use into `build/native/` beside
the package (listed in .gitignore), keyed by a hash of the source, the
flags and the host CPU (the build uses -march=native), and loaded once
per process with ctypes, the way `build.py` builds the CUDA kernels.  It
is never loaded from anywhere else.

The bindings are those of `zukelang_tpu/native/__init__.py`, with its
byte formats (little-endian standard-form Fr of 32 bytes, affine G1 of
97: x, y and an infinity byte): Fr batch products and inverses, the
radix-2 NTT over Fr, G1 scalar multiplication and MSM, and the pairing.
They take and return golden values.

There is no fallback: when the compiler is missing (or `CXX` names one
that is missing), the build fails or the library does not load,
`library()` raises, and so does every binding.  The golden pairing is
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
from typing import List

from . import params
from .golden.curve import G1, GT
from .golden.field import Fq, Fq2, Fq6, Fq12, Fr

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
    """`CXX` where it is set (it must exist), else g++, c++ or clang++."""
    cxx = os.environ.get("CXX")
    for name in ((cxx,) if cxx else ("g++", "c++", "clang++")):
        if shutil.which(name):
            return shutil.which(name)
    raise RuntimeError(f"no C++ compiler ({cxx!r} from CXX)" if cxx else
                       "no C++ compiler (g++, c++ or clang++; or set CXX): "
                       "the native library cannot be built")


# ctypes signatures: name -> argument types (every function returns void)
_P = ctypes.c_char_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "fr_mul_batch": [_P, _P, _P, _I64],
    "fr_inv_batch": [_P, _P, _I64],
    "fr_ntt": [_P, _I64, _P, ctypes.c_int, _P],
    "g1_scalar_mul": [_P, _P, _P],
    "g1_msm": [_P, _P, _I64, _P],
    "gt_multi_pairing": [_P, _P, _P, _P, _I64, _P],
}


def library() -> ctypes.CDLL:
    """The host library, built on first use."""
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
            raise RuntimeError("native library build failed:\n"
                               + res.stderr[-8000:])
        os.replace(tmp, out)
        build_seconds = time.time() - t0
    lib = ctypes.CDLL(out)
    lib.native_abi_version.argtypes = []
    lib.native_abi_version.restype = ctypes.c_int
    if lib.native_abi_version() != 1:
        raise RuntimeError(f"{out}: unexpected ABI version")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    _lib = lib
    return _lib


# -- converters --------------------------------------------------------------

def _frs_to_bytes(xs: List[Fr]) -> bytes:
    return b"".join(x.n.to_bytes(32, "little") for x in xs)


def _bytes_to_frs(b: bytes) -> List[Fr]:
    return [Fr(int.from_bytes(b[i * 32:(i + 1) * 32], "little"))
            for i in range(len(b) // 32)]


def _g1s_to_bytes(pts: List[G1]) -> bytes:
    out = bytearray()
    for p in pts:
        if p.is_zero():
            out += bytes(96) + b"\x01"
        else:
            out += p.x.n.to_bytes(48, "little")
            out += p.y.n.to_bytes(48, "little")
            out += b"\x00"
    return bytes(out)


def _bytes_to_g1(b: bytes) -> G1:
    if b[96]:
        return G1.zero()
    x = int.from_bytes(b[:48], "little")
    y = int.from_bytes(b[48:96], "little")
    return G1(Fq(x), Fq(y))


# -- API ---------------------------------------------------------------------

def fr_mul_batch(a: List[Fr], b: List[Fr]) -> List[Fr]:
    """[x * y for x, y in zip(a, b)]."""
    lib = library()
    if len(a) != len(b):
        raise ValueError(f"fr_mul_batch: {len(a)} and {len(b)} elements")
    out = ctypes.create_string_buffer(32 * len(a))
    lib.fr_mul_batch(_frs_to_bytes(a), _frs_to_bytes(b), out, len(a))
    return _bytes_to_frs(out.raw)


def fr_inv_batch(a: List[Fr]) -> List[Fr]:
    """[x^-1 for x in a], zero for zero."""
    lib = library()
    out = ctypes.create_string_buffer(32 * len(a))
    lib.fr_inv_batch(_frs_to_bytes(a), out, len(a))
    return _bytes_to_frs(out.raw)


def fr_ntt(values: List[Fr], inverse: bool = False) -> List[Fr]:
    """The radix-2 NTT over Fr in natural order (the inverse with the 1/N
    scaling), on the host."""
    from .ops.ntt import root_for
    lib = library()
    n = len(values)
    if n < 1 or n & (n - 1):
        raise ValueError(f"fr_ntt: length {n} is not a power of two")
    logn = n.bit_length() - 1
    w = root_for(logn, inverse)
    buf = ctypes.create_string_buffer(_frs_to_bytes(values), 32 * n)
    ninv = pow(n, -1, params.R)
    lib.fr_ntt(buf, logn, w.to_bytes(32, "little"), 1 if inverse else 0,
               ninv.to_bytes(32, "little"))
    return _bytes_to_frs(buf.raw)


def g1_msm(points: List[G1], scalars: List[Fr]) -> G1:
    """sum_i scalars[i] * points[i] (Pippenger, c = 8, on the host)."""
    lib = library()
    if len(points) != len(scalars):
        raise ValueError(f"g1_msm: {len(points)} points and {len(scalars)} "
                         "scalars")
    out = ctypes.create_string_buffer(97)
    lib.g1_msm(_g1s_to_bytes(points), _frs_to_bytes(scalars), len(points),
               out)
    return _bytes_to_g1(out.raw)


def g1_scalar_mul(point: G1, scalar: Fr) -> G1:
    lib = library()
    out = ctypes.create_string_buffer(97)
    lib.g1_scalar_mul(_g1s_to_bytes([point]), scalar.n.to_bytes(32, "little"),
                      out)
    return _bytes_to_g1(out.raw)


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


def gt_pairing(p, q) -> GT:
    """e(P, Q) through the C++ tower."""
    return gt_multi_pairing([(p, q)])
