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
Beyond them: the G2 group law (`g2_add`, `g2_scalar_mul`; affine G2 of
193 bytes: x.c0, x.c1, y.c0, y.c1 and an infinity byte, the layout the
pairing reads) and the Groth16 proof assembly (`groth16_assemble`: the
proof points from the CRS's host points, the five MSM sums and r, s, in
one call) and the Pinocchio ZK fold (`pinocchio_zk_fold`: the ZK proof
from the NonZK MSM sums, the proving key's single points and tails and
dv, dw, dy, in one call).  They take and return golden values.

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
from typing import List, Tuple

from . import params
from .golden.curve import G1, G2, GT
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
    "g2_scalar_mul": [_P, _P, _P],
    "g2_add": [_P, _P, _P],
    "groth16_assemble": [_P, _P, _P, _P, _P, _P, _P],
    "pinocchio_zk_fold": [_P, _P, _P, _P, _P, _P, _I64, _P, _P],
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


def _g2s_to_bytes(pts: List[G2]) -> bytes:
    out = bytearray()
    for p in pts:
        if p.is_zero():
            out += bytes(192) + b"\x01"
        else:
            for v in (p.x.c0, p.x.c1, p.y.c0, p.y.c1):
                out += v.n.to_bytes(48, "little")
            out += b"\x00"
    return bytes(out)


def _bytes_to_g2(b: bytes) -> G2:
    if b[192]:
        return G2.zero()
    v = [int.from_bytes(b[48 * k:48 * (k + 1)], "little") for k in range(4)]
    return G2(Fq2.of_ints(v[0], v[1]), Fq2.of_ints(v[2], v[3]))


def _scalar_bytes(k) -> bytes:
    """Fr of either package (a canonical int `.n`) -> 32 bytes, reduced
    mod r as the golden group law reduces its scalars."""
    return (k.n % params.R).to_bytes(32, "little")


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
    lib.g1_scalar_mul(_g1s_to_bytes([point]), _scalar_bytes(scalar), out)
    return _bytes_to_g1(out.raw)


def g2_scalar_mul(point: G2, scalar: Fr) -> G2:
    lib = library()
    out = ctypes.create_string_buffer(193)
    lib.g2_scalar_mul(_g2s_to_bytes([point]), _scalar_bytes(scalar), out)
    return _bytes_to_g2(out.raw)


def g2_add(p: G2, q: G2) -> G2:
    lib = library()
    out = ctypes.create_string_buffer(193)
    lib.g2_add(_g2s_to_bytes([p]), _g2s_to_bytes([q]), out)
    return _bytes_to_g2(out.raw)


def groth16_assemble(alpha_g1: G1, beta_g1: G1, delta_g1: G1, beta_g2: G2,
                     delta_g2: G2, A: G1, B1: G1, H: G1, Cmid: G1, B: G2,
                     r: Fr, s: Fr) -> Tuple[G1, G2, G1]:
    """The Groth16 proof points (a, b, c) (groth16.ml:123-161) from the
    CRS's host points, the MSM sums A, B1, H, C-mid (G1) and B (G2), and
    the prover's r and s:
    a = alpha + A + delta r, b = beta_2 + B + delta_2 s,
    c = Cmid + H + a s + (beta + B1 + delta s) r - delta (r s)."""
    lib = library()
    out = ctypes.create_string_buffer(97 + 193 + 97)
    lib.groth16_assemble(_g1s_to_bytes([alpha_g1, beta_g1, delta_g1]),
                         _g2s_to_bytes([beta_g2, delta_g2]),
                         _g1s_to_bytes([A, B1, H, Cmid]), _g2s_to_bytes([B]),
                         _scalar_bytes(r), _scalar_bytes(s), out)
    raw = out.raw
    return (_bytes_to_g1(raw[:97]), _bytes_to_g2(raw[97:290]),
            _bytes_to_g1(raw[290:]))


def pinocchio_zk_fold(singles_g1: List[G1], singles_g2: List[G2],
                      sums_g1: List[G1], sums_g2: List[G2],
                      v_tail: List[G1], w_tail: List[G1], tail: List,
                      dv: Fr, dw: Fr, dy: Fr) -> Tuple:
    """The Pinocchio ZK proof points (vv, ww, yy, h, vavv, waww, yayy,
    bvwy; pinocchio.ml:427-514) from the proving key's single points
    (singles_g1: vt, yt, vavt, yayt, vbt, wbt, ybt, t1, the generator;
    singles_g2: wt, wawt), the MSM sums (sums_g1: vv, yy, h, vavv, yayy,
    bvwy, v_all, w_all; sums_g2: ww, waww), the all-variable tails
    (v_tail, w_tail: host points; tail: the witness values of those
    columns, ints) and the prover's dv, dw, dy:
    vv + vt dv, ww + wt dw, yy + yt dy,
    h + V dw + W dv + t1 (dv dw) - g dy (V = v_all + sum c_i v_tail_i,
    W = w_all + sum c_i w_tail_i), vavv + vavt dv, waww + wawt dw,
    yayy + yayt dy, bvwy + vbt dv + wbt dw + ybt dy."""
    lib = library()
    if (len(singles_g1), len(singles_g2), len(sums_g1), len(sums_g2)) != (
            9, 2, 8, 2):
        raise ValueError("pinocchio_zk_fold: want 9 + 2 single points and "
                         "8 + 2 sums")
    if not len(v_tail) == len(w_tail) == len(tail):
        raise ValueError(f"pinocchio_zk_fold: {len(v_tail)}, {len(w_tail)} "
                         f"tail points and {len(tail)} values")
    out = ctypes.create_string_buffer(6 * 97 + 2 * 193)
    lib.pinocchio_zk_fold(
        _g1s_to_bytes(singles_g1), _g2s_to_bytes(singles_g2),
        _g1s_to_bytes(sums_g1), _g2s_to_bytes(sums_g2),
        _g1s_to_bytes(list(v_tail) + list(w_tail)),
        b"".join((c % params.R).to_bytes(32, "little") for c in tail),
        len(tail), b"".join(_scalar_bytes(k) for k in (dv, dw, dy)), out)
    raw, pts, at = out.raw, [], 0
    for group in (G1, G2, G1, G1, G1, G2, G1, G1):
        size = 97 if group is G1 else 193
        pts.append((_bytes_to_g1 if group is G1 else _bytes_to_g2)(
            raw[at:at + size]))
        at += size
    return tuple(pts)


def gt_multi_pairing(pairs) -> GT:
    """prod_i e(P_i, Q_i) through the C++ tower, with one shared final
    exponentiation."""
    lib = library()
    g1 = [_g1s_to_bytes([p]) for p, _ in pairs]
    g2 = [_g2s_to_bytes([q]) for _, q in pairs]
    out = ctypes.create_string_buffer(576)
    lib.gt_multi_pairing(b"".join(x[:96] for x in g1),
                         bytes(x[96] for x in g1),
                         b"".join(x[:192] for x in g2),
                         bytes(x[192] for x in g2), len(pairs), out)
    raw = out.raw
    vals = [int.from_bytes(raw[i * 48:(i + 1) * 48], "little")
            for i in range(12)]
    f2 = [Fq2.of_ints(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return GT(Fq12(Fq6(f2[0], f2[1], f2[2]), Fq6(f2[3], f2[4], f2[5])))


def gt_pairing(p, q) -> GT:
    """e(P, Q) through the C++ tower."""
    return gt_multi_pairing([(p, q)])
