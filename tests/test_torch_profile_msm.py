"""The window profiler's stages on CPU tensors (every kernel its plain
version), at 2^8 bases and c = 8 (nb = 129 buckets padded to 192, the
K = 64 chunked reduce), the shared timing helper, and the row orders
`profile_kernels` times K5 at.

The profiler holds its two off-route stages against the window
program's route itself (the K3 phase 1's buckets against the K8 route's,
the log-depth carry scan against the K7 route's); here that check must
pass and no kernel may launch.  Tolerance: exact, as affine points."""

import pytest
import torch

from zukelang_tpu_torch import profile_msm
from zukelang_tpu_torch.ops import kernels as K
from zukelang_tpu_torch.ops import msm
from zukelang_tpu_torch.timing import time_ms

torch.set_num_threads(1)


def test_profile_stages_on_cpu_tensors_agree_with_the_window_route():
    K.reset_counts()
    res, st = profile_msm.profile(8, 8, torch.device("cpu"), reps=1,
                                  log=lambda s: None)
    assert res["stage_checks"] == {"k3_route_buckets_equal_k8_route": True,
                                   "hs_carry_scan_equal_k7_route": True}
    assert not res["k8_flagged"]
    assert set(res["stages_ms"]) >= {"sort_k4_digit_sort", "k8_bucket_scan",
                                     "chunked_phase1_k3", "window_program",
                                     "msm_staged"}
    assert all(v == 0 for v in K.LAUNCHES.values())
    assert res["n_buckets"] == 129 and st["nb_pad"] == 192
    # the window profiled is window 3 of the signed digits, sorted
    absd = st["digits"][profile_msm.WINDOW].abs()
    assert torch.equal(st["d_sorted"], torch.sort(absd, stable=True)[0])
    assert torch.equal(st["absd"][0], absd)
    assert st["ph1"][0].shape == st["k8_scan"][0].shape == (12, 256)
    assert st["buckets"][0].shape == (12, msm.n_buckets(8))


@pytest.mark.parametrize("stat", ["min", "mean"])
def test_time_ms_returns_the_last_output(stat):
    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    ms, out = time_ms(fn, torch.device("cpu"), reps=4, stat=stat)
    assert ms >= 0 and out == 5 and len(calls) == 5   # a warm-up, then 4


def test_time_ms_refuses_an_unknown_statistic():
    with pytest.raises(ValueError):
        time_ms(lambda: None, torch.device("cpu"), stat="median")


def test_k5_row_orders_keep_the_shape_and_each_block_rows_set():
    """The orders K5 is timed at: the MSM's own index array, its rows
    sorted within each block row, and the table's rows in order."""
    from zukelang_tpu_torch.profile_kernels import row_orders
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 96, (3, 64), generator=gen, dtype=torch.int32)
    orders = row_orders(idx, 96)
    assert list(orders) == ["prove", "sorted", "arange"]
    assert orders["prove"] is idx
    srt = orders["sorted"]
    assert srt.dtype == torch.int32 and srt.shape == idx.shape
    assert bool((srt[:, 1:] >= srt[:, :-1]).all())
    assert torch.equal(srt, torch.sort(idx, dim=-1).values)
    seq = orders["arange"]
    assert seq.dtype == torch.int32 and seq.shape == idx.shape
    assert torch.equal(seq.reshape(-1),
                       torch.arange(3 * 64, dtype=torch.int32) % 96)
