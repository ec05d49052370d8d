"""The port's stand-alone polynomial API (`zukelang_tpu_torch/ops/fft.py`)
on the CPU, with the JAX package's `tests/test_fft.py` cases: the
complex instance's round trip (1e-9) and product against numpy's
convolution (1e-6), and the transform against numpy's FFT (complex128,
1e-9; the JAX instance computes in complex64, so it is not the
reference here); the Fr instance (the NTT kernel's and K1's plain
versions) word for word equal to the JAX `fft.fft_fr` and
`polynomial_mul_fr` and to the naive `poly.mul`, and to the host
library's `native.fr_ntt` both ways.

Tolerance: as stated for the complex instance; exact for Fr."""

import random

import numpy as np
import pytest
import torch

from zukelang_tpu.golden.field import Fr as JFr
from zukelang_tpu.ops import fft as jfft
from zukelang_tpu_torch import native, params
from zukelang_tpu_torch.core import poly
from zukelang_tpu_torch.golden.field import Fr
from zukelang_tpu_torch.ops import fft

torch.set_num_threads(1)
CPU = "cpu"


def _rand_poly(r, n):
    return [Fr(r.randrange(params.R)) for _ in range(n)]


def _jax(p):
    return [JFr(x.n) for x in p]


def _ints(p):
    return [x.n for x in p]


def test_fft_c_roundtrip_and_numpy():
    r = random.Random(9)
    p = [complex(r.uniform(-10, 10), r.uniform(-10, 10)) for _ in range(13)]
    vals = fft.fft_c(p, device=CPU)
    assert vals.shape == (16,)
    assert np.allclose(vals, np.fft.fft(np.array(p + [0] * 3)), atol=1e-9)
    back = fft.ifft_c(vals, device=CPU)[: len(p)]
    assert np.allclose(back, p, atol=1e-9)


def test_polynomial_mul_c_matches_naive():
    r = random.Random(9)
    p1 = [complex(r.uniform(-5, 5)) for _ in range(9)]
    p2 = [complex(r.uniform(-5, 5)) for _ in range(6)]
    got = fft.polynomial_mul_c(p1, p2, device=CPU)
    assert np.allclose(got, np.convolve(p1, p2), atol=1e-6)


def test_fft_fr_roundtrip_and_the_jax_package():
    r = random.Random(9)
    p = _rand_poly(r, 11)
    vals = fft.fft_fr(p, device=CPU)
    assert _ints(vals) == _ints(jfft.fft_fr(_jax(p)))
    assert fft.ifft_fr(vals, device=CPU)[: len(p)] == p
    assert _ints(fft.fft_fr(p[:1], device=CPU)) == [p[0].n] * 2   # size >= 2


@pytest.mark.parametrize("n1,n2", [(5, 7), (8, 8), (1, 9)])
def test_polynomial_mul_fr_matches_jax_and_naive(n1, n2):
    r = random.Random(n1 * 100 + n2)
    p1, p2 = _rand_poly(r, n1), _rand_poly(r, n2)
    got = fft.polynomial_mul_fr(p1, p2, device=CPU)
    assert _ints(got) == _ints(jfft.polynomial_mul_fr(_jax(p1), _jax(p2)))
    assert poly.equal(got, poly.mul(p1, p2))
    assert len(got) == n1 + n2 - 1
    assert fft.polynomial_mul_fr([], p2, device=CPU) == []


def test_native_ntt_matches_fft_fr():
    p = _rand_poly(random.Random(16), 16)
    assert native.fr_ntt(p) == fft.fft_fr(p, device=CPU)
    assert native.fr_ntt(native.fr_ntt(p), inverse=True) == p
    assert native.fr_ntt(p, inverse=True) == fft.ifft_fr(p, device=CPU)


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: fft.fft_fr([Fr(1)]), lambda: fft.ifft_fr([Fr(1)] * 2),
                 lambda: fft.polynomial_mul_fr([Fr(1)], [Fr(2)]),
                 lambda: fft.fft_c([1j])):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
