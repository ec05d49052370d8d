"""K8's plain version for G2 against the JAX package's log-depth segmented
scan (`msm._hs_segmented_scan`, XLA on the CPU) and the golden segmented
prefix sums, on tests/test_torch_k8_scan.py's clean case: a file of its
own, as the JAX G2 scan's compile alone takes about 15 s on one thread.

Tolerance: exact, as compressed golden points."""

import torch

from test_torch_k8_scan import KC, _affine, _bytes, _clean_case, _golden, \
    _jax_scan
from zukelang_tpu_torch.golden.curve import G2
from zukelang_tpu_torch.ops import curve as C
from zukelang_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


def test_jax_g2_scan_equals_the_golden_sums_and_the_plain_scan():
    """The JAX scan, the golden sums and the plain version at the
    wrapper's g agree."""
    pts, seg = _clean_case("g2")
    P = _affine(pts, "g2")
    s = torch.tensor(seg, dtype=torch.int32)
    want = _bytes(_golden(pts, seg, G2))
    assert _jax_scan(P, seg, "g2") == want
    got, flag = K.bucket_scan_plain(P, s, KC, "g2")
    assert not bool(flag.any())
    assert _bytes(C.unpack_g2(got)) == want
