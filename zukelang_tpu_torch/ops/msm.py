"""Multi-scalar multiplication (Pippenger) and fixed-base batches.

Counterpart of `zukelang_tpu/ops/msm.py`:

  * `msm_many_staged_deferred` / `msm_staged_deferred`: signed-digit
    Pippenger.  The signed digits of a whole batch come from one K9
    launch.  Per window: digit sort (K4), then the in-chunk segmented
    mixed-add scan (K5) over the sorted, sign-applied affine points, which
    K5 gathers from the row table itself; then, batched over every window
    of every MSM, the cross-chunk carry scan (K7, its carry adds and its
    Hillis-Steele tail each one K2 launch), bucket assembly (one K2 carry
    add), the weighted bucket reduction (K6, K2) and the window combine
    (one K2 chained-doubling launch, then one K2 small scan or K7).
  * `fixed_base_mul`: batched g*s from a window table of multiples of the
    generator (built with K7), summed by K5 (one segment per element) from
    128 elements, by one K3 chain launch of the window loop below;
    `g_powers` is the powers of one scalar as such a batch.

  * `window_program`: the JAX package's per-window program
    (`_jit_window`), the route of its MSM profilers.  Affine bases take
    the K8 route (`_bucket_sums_fused`: K4 sort, gather, K8 scan, carry
    scatter with K7 and K2); the chunked (one K3 chain) and Jacobian
    (log-depth K2 scan) variants keep their JAX routes.  `msm_staged` on
    Jacobian (X, Y, Z) bases runs the Jacobian variant over every window,
    as the JAX package's fused program does on non-affine bases; it
    returns a golden point.

Where the JAX package scans over windows, the v2 MSM runs each stage once
over all windows: the windows' chunk lanes sit side by side in one
kernel launch.  Its widths must be multiples of 32 and at least 64
(callers pad), so the v1 window inside the JAX MSM entry points is never
taken; `window_program` is the only v1 route.

Scalars cross this API as (8, N) int32 tensors of 32-bit limbs, standard
form unless the name says Montgomery.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .. import util
from ..golden.curve import G1, G2
from ..params import FQ, FR
from . import curve as C
from . import field as F
from . import kernels as kern

CHUNK = 32  # K: points per scan lane (K5, K6, K7)


# ---------------------------------------------------------------------------
# Digits
# ---------------------------------------------------------------------------

def _scalars_to_windows(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(8, N) standard-form scalars -> (W, N) int32 window digits, least
    significant window first; 1 <= c <= 16."""
    assert 1 <= c <= 16
    nl = scalars_std.shape[0]
    u = F.u64(scalars_std)
    mask = (1 << c) - 1
    outs = []
    for w in range(-(-32 * nl // c)):
        k, off = divmod(w * c, 32)
        v = u[k] >> off
        if off + c > 32 and k + 1 < nl:
            v = v | (u[k + 1] << (32 - off))
        outs.append(v & mask)
    return torch.stack(outs).to(torch.int32)


def _scalars_to_signed_windows(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(8, N) scalars -> (W, N) int32 signed digits in
    [-(2^(c-1) - 1), 2^(c-1)] with sum_w d_w 2^(cw) = scalar.  |d| picks
    one of 2^(c-1) + 1 buckets; the sign negates the point.  The carry out
    of the top window is absorbed: scalars are < 2^255."""
    raw = _scalars_to_windows(scalars_std, c)
    half, full = 1 << (c - 1), 1 << c
    outs = []
    carry = torch.zeros_like(raw[0])
    for w in range(raw.shape[0]):
        v = raw[w] + carry
        ge = v > half
        outs.append(torch.where(ge, v - full, v))
        carry = ge.to(torch.int32)
    return torch.stack(outs)


def auto_window(n: int) -> int:
    """Window width minimizing ceil(256/c) * (1.3 N + 3.5 * 2^(c-1)),
    clamped to [4, 16] (the JAX package's cost model)."""
    best, best_cost = 4, None
    for c in range(4, 17):
        cost = -(-256 // c) * (1.3 * n + 3.5 * (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def n_buckets(c: int) -> int:
    return (1 << (c - 1)) + 1


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _flat(v: torch.Tensor) -> torch.Tensor:
    """Coordinate -> (rows, N): G2's (2, 12, N) becomes (24, N)."""
    return v.reshape(-1, v.shape[-1])


def _to_curve(v: torch.Tensor, group: str) -> torch.Tensor:
    return v.reshape(2, v.shape[0] // 2, v.shape[-1]) if group == "g2" else v


def _neg_y(y: torch.Tensor) -> torch.Tensor:
    return F.fq2_neg(y) if y.dim() == 3 else F.neg(y, FQ)


def _shift1(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _pad_blocks(x: torch.Tensor, nblk: int, per_in: int,
                per_out: int) -> torch.Tensor:
    """(.., nblk*per_in) -> (.., nblk*per_out), zero (= infinity)
    padding at each block's high end."""
    if per_in == per_out:
        return x
    xb = x.reshape(x.shape[:-1] + (nblk, per_in))
    xb = torch.nn.functional.pad(xb, (0, per_out - per_in))
    return xb.reshape(x.shape[:-1] + (nblk * per_out,))


def _prep_rows(points: C.AffinePoint) -> torch.Tensor:
    """Affine (X, Y) batch -> (2N, R) row table [X;Y | X;-Y]: one row
    gather by (order + N*sign) fetches sorted, sign-applied points."""
    X, Y = points
    top = torch.cat([_flat(X), _flat(Y)], dim=0)
    bot = torch.cat([_flat(X), _flat(_neg_y(Y))], dim=0)
    return torch.cat([top, bot], dim=1).t().contiguous()


def _hs_segmented_scan(points: C.Point, seg: torch.Tensor,
                       span: int = None) -> C.Point:
    """Inclusive segmented prefix sum along the batch axis (seg sorted),
    log-depth: up to `kern.SEG_SCAN_SMALL_MAX` points all rounds in one K2
    launch (`seg_scan_small`), above one K2 point add a round (log2 of
    `span`, the longest segment, rounds; default the batch)."""
    if seg.shape[-1] <= kern.SEG_SCAN_SMALL_MAX:
        return kern.seg_scan_small(points, seg.to(torch.int32))
    return kern.hs_rounds(points, seg, C.point_add, span)


def _hs_total(points: C.Point) -> C.Point:
    n = points[0].shape[-1]
    seg = torch.zeros(n, dtype=torch.int32, device=points[0].device)
    return tuple(v[..., -1:] for v in _hs_segmented_scan(points, seg))


def _carry_index(take: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """The carry of each lane for `kern.point_add_carry`: the scanned tail
    of the chunk before its own (`chunk`, flat chunk indices) where `take`,
    else -1 (nothing added).  int32, flat."""
    return torch.where(take, chunk - 1, -1).to(torch.int32).reshape(-1)


def _seg_scan_auto(points: C.Point, seg: torch.Tensor,
                   K: int = CHUNK) -> C.Point:
    """Inclusive segmented prefix sum (seg sorted): K7 over chunks of K,
    recursion over the chunk tails, one K2 carry add."""
    n = seg.shape[-1]
    if n % K != 0 or n // K < 2:
        return _hs_segmented_scan(points, seg)
    scanned = kern.jac_scan(points, K, seg)
    M = n // K
    last_seg, first_seg = seg[K - 1::K], seg[0::K]
    car = _seg_scan_auto(tuple(x[..., K - 1::K] for x in scanned),
                         last_seg, K)
    # the carry into chunk m is chunk m-1's scanned tail when its last
    # segment continues into chunk m; it applies to chunk m's first segment
    match = torch.zeros(M, dtype=torch.bool, device=seg.device)
    match[1:] = last_seg[:-1] == first_seg[1:]
    elem = seg.reshape(M, K) == first_seg[:, None]
    chunk = torch.arange(M, dtype=torch.int32, device=seg.device)[:, None]
    idx = _carry_index(match[:, None] & elem, chunk)
    return kern.point_add_carry(scanned, car, idx)


def _total_auto(points: C.Point, K: int = CHUNK) -> C.Point:
    """Sum of all points -> batch 1: K7 chunk scans, recursively."""
    n = points[0].shape[-1]
    if n % K != 0 or n // K < 2:
        return _hs_total(points)
    scanned = kern.jac_scan(points, K)
    return _total_auto(tuple(x[..., K - 1::K] for x in scanned), K)


# ---------------------------------------------------------------------------
# The v1 window: one window's bucket sums and weighted reduce
# ---------------------------------------------------------------------------

# Times `_bucket_sums_fused` found a flagged K8 lane and took the
# collision-safe `_bucket_sums` (the JAX package's lax.cond).
FALLBACKS = {"bucket_sums_fused": 0}


def _apply_signs(points, dig_signed: torch.Tensor):
    """-> (points with Y negated where the digit is negative, |digits|)."""
    neg = dig_signed < 0
    y = kern.select_lanes(neg, _neg_y(points[1]), points[1])
    return (points[0], y) + tuple(points[2:]), dig_signed.abs()


def _group(points) -> str:
    return kern.group_of(points[0])


def _scatter_tails(scanned: C.Point, d_sorted: torch.Tensor,
                   n_buckets: int) -> C.Point:
    """The last (inclusive-scan) element of each segment into its bucket;
    the other elements go to a dummy slot that is cut off."""
    is_tail = torch.ones_like(d_sorted, dtype=torch.bool)
    is_tail[:-1] = d_sorted[:-1] != d_sorted[1:]
    tgt = torch.where(is_tail, d_sorted.to(torch.int64), n_buckets)
    out = C.infinity(_group(scanned), n_buckets + 1, d_sorted.device)
    for b, v in zip(out, scanned):
        b[..., tgt] = v
    return tuple(b[..., :n_buckets] for b in out)


def _sort_gather(points, digits: torch.Tensor):
    """Stable sort by digit (the JAX package's jnp.argsort) and gather."""
    d_sorted, order = torch.sort(digits, stable=True)
    return tuple(x[..., order] for x in points), d_sorted


def _bucket_sums(points: C.Point, digits: torch.Tensor,
                 n_buckets: int) -> C.Point:
    """Per-bucket sums of one window, collision-safe: sort, log-depth
    segmented scan of K2 adds, scatter of the segment tails
    (`_window_buckets` of one window)."""
    return _window_buckets(points, digits[None], n_buckets)


def _madd_chunk_scan(pts, d_sorted: torch.Tensor, K: int):
    """Phase 1 of `_bucket_sums_chunked`: K steps over the N/K chunk lanes,
    restarting at segment starts; affine points in one K3 chain launch
    (`point_madd_chain`, every step kept), Jacobian ones one K2 add a
    step.  Returns the flat in-chunk scan."""
    affine = len(pts) == 2
    if affine:
        return kern.point_madd_chain(pts, K, seg=d_sorted.to(torch.int32),
                                     keep=True)
    n = d_sorted.shape[-1]
    M = n // K
    d2 = d_sorted.reshape(M, K)
    p2 = tuple(x.reshape(x.shape[:-1] + (M, K)) for x in pts)

    acc = tuple(x[..., 0] for x in p2)
    outs = [acc]
    for t in range(1, K):
        cur = tuple(x[..., t] for x in p2)
        added = C.point_add(acc, cur)
        same = d2[:, t] == d2[:, t - 1]
        acc = tuple(kern.select_lanes(same, a, c)
                    for a, c in zip(added, cur))
        outs.append(acc)
    return tuple(torch.stack([o[i] for o in outs], dim=-1).reshape(
        outs[0][i].shape[:-1] + (n,)) for i in range(3))


def _bucket_sums_chunked(points, digits: torch.Tensor, n_buckets: int,
                         K: int = CHUNK) -> C.Point:
    """Work-efficient bucket sums: sort, the K-step in-chunk scan (phase
    1), then `_carry_scatter`.  `points` affine (2-tuple, K3 in phase 1)
    or Jacobian (K2)."""
    n = digits.shape[-1]
    if n % K != 0 or n // K < 2:
        if len(points) == 2:
            points = C.affine_to_jac(points)
        return _bucket_sums(points, digits, n_buckets)
    pts, d_sorted = _sort_gather(points, digits)
    return _carry_scatter(_madd_chunk_scan(pts, d_sorted, K), d_sorted,
                          n_buckets, K)


def _carry_scatter(scan_flat: C.Point, d_sorted: torch.Tensor,
                   n_buckets: int, K: int) -> C.Point:
    """Phases 2 and 3 of the chunked bucket sums, from the flat in-chunk
    scan (chunk m = sorted elements [m*K, (m+1)*K)): a segmented scan of
    the chunk-end partials by each chunk's last digit (K7, `_seg_scan_auto`),
    then the carry into chunk m lands at bucket first_seg[m] when that
    segment's tail lies in chunk m, added to the scattered tails with one
    K2 add."""
    dev = d_sorted.device
    M = d_sorted.shape[-1] // K
    last_seg, first_seg = d_sorted[K - 1::K], d_sorted[0::K]
    car = _seg_scan_auto(tuple(x[..., K - 1::K] for x in scan_flat),
                         last_seg)
    match = torch.zeros(M, dtype=torch.bool, device=dev)
    match[1:] = last_seg[:-1] == first_seg[1:]
    buckets = _scatter_tails(scan_flat, d_sorted, n_buckets)
    continues = torch.zeros(M, dtype=torch.bool, device=dev)
    continues[:-1] = ((last_seg == first_seg)[:-1]
                      & (first_seg[1:] == first_seg[:-1]))
    # bucket first_seg[m] takes chunk m's carry; no two such chunks share
    # a bucket (a bucket spanning chunks continues in all but its last)
    tgt = torch.where(match & ~continues, first_seg.to(torch.int64),
                      n_buckets)
    chunk_of = torch.zeros(n_buckets + 1, dtype=torch.int32, device=dev)
    chunk_of[tgt] = torch.arange(M, dtype=torch.int32, device=dev)
    take = torch.zeros(n_buckets + 1, dtype=torch.bool, device=dev)
    take[tgt] = True
    idx = _carry_index(take[:n_buckets], chunk_of[:n_buckets])
    return kern.point_add_carry(buckets, car, idx)


def _bucket_sums_fused(points: C.AffinePoint, digits: torch.Tensor,
                       n_buckets: int, K: int = CHUNK) -> C.Point:
    """Bucket sums of affine points with phase 1 as one K8 launch: K4
    digit sort, gather, K8, `_carry_scatter`.  Where K8 flags a lane (a
    doubling case: equal points in a row of one bucket), the window takes
    the collision-safe `_bucket_sums` on the sorted points instead, as the
    JAX package's lax.cond does; that costs one host read of the flags."""
    n = digits.shape[-1]
    if n % K != 0 or n // K < 2:
        return _bucket_sums(C.affine_to_jac(points), digits, n_buckets)
    d_sorted, order = kern.digit_sort(digits.reshape(1, n), n_buckets)
    d_sorted = d_sorted[0]
    pts = tuple(x[..., order[0].to(torch.int64)] for x in points)
    scanned, collided = kern.bucket_scan(pts, d_sorted, K, _group(points))
    if bool(collided.any()):
        FALLBACKS["bucket_sums_fused"] += 1
        return _bucket_sums(C.affine_to_jac(pts), d_sorted, n_buckets)
    return _carry_scatter(scanned, d_sorted, n_buckets, K)


def _chunked_prefix_scan(points: C.Point, K: int) -> C.Point:
    """Unsegmented inclusive prefix sum: K7 in chunks of K, a scan of the
    chunk totals (`_seg_scan_auto`), one K2 add of the carries."""
    n = points[0].shape[-1]
    M = n // K
    scanned = kern.jac_scan(points, K)
    dev = points[0].device
    car = _seg_scan_auto(tuple(x[..., K - 1::K] for x in scanned),
                         torch.zeros(M, dtype=torch.int32, device=dev))
    chunk = torch.arange(n, dtype=torch.int32, device=dev) // K
    return kern.point_add_carry(scanned, car, _carry_index(chunk > 0, chunk))


def _set_infinity(points: C.Point, col: int) -> C.Point:
    inf = C.infinity(_group(points), 1, points[0].device)
    out = tuple(v.clone() for v in points)
    for v, i in zip(out, inf):
        v[..., col:col + 1] = i
    return out


def _weighted_bucket_reduce(buckets: C.Point, K: int = 64) -> C.Point:
    """sum_{b>=1} b * S_b as the sum of the suffix sums T_j (j >= 1):
    chunked (K7, K2) where B is a multiple of K with at least two chunks,
    else the log-depth K2 scans."""
    B = buckets[0].shape[-1]
    rev = tuple(torch.flip(v, dims=(-1,))
                for v in _set_infinity(buckets, 0))     # weight of S_0 is 0
    chunked = B % K == 0 and B // K >= 2
    if chunked:
        sc = _chunked_prefix_scan(rev, K)               # sc[k] = T_{B-1-k}
    else:
        sc = _hs_segmented_scan(rev, torch.zeros(
            B, dtype=torch.int32, device=rev[0].device))
    sc = _set_infinity(sc, B - 1)                       # drop T_0
    return _total_auto(sc, K) if chunked else _hs_total(sc)


def _pad_buckets(buckets: C.Point, nb_to: int) -> C.Point:
    """Pad at the high end with infinities (b * infinity adds nothing)."""
    cur = buckets[0].shape[-1]
    if cur >= nb_to:
        return buckets
    inf = C.infinity(_group(buckets), nb_to - cur, buckets[0].device)
    return tuple(torch.cat([a, b], dim=-1) for a, b in zip(buckets, inf))


@functools.lru_cache(maxsize=64)
def window_program(group: str, c: int, chunked: bool = True,
                   affine: bool = False, signed: bool = True):
    """One Pippenger window, the counterpart of the JAX package's
    `_jit_window`: `run(points, dig)` takes the bases (affine (X, Y) when
    `affine`, else Jacobian) and one window's digits (N,) (signed in
    [-(2^(c-1) - 1), 2^(c-1)] when `signed`) and returns the window's
    weighted bucket sum, a batch-1 point.  Affine bases take the K8 route
    on every device; the profiler and `chip_smoke.py` run it (affine,
    signed).  Jacobian bases with `chunked=False` (signed) are the route
    of `msm_staged` on Jacobian bases, which `bench_msm` times.  The
    chunked Jacobian and the unsigned variants stay for parity with
    `_jit_window`, held against it by the tests."""
    def bucket_fn(points, dig, nb):
        if affine:
            return _bucket_sums_fused(points, dig, nb)
        if not chunked:
            return _bucket_sums(points, dig, nb)
        return _bucket_sums_chunked(points, dig, nb)

    def run(points, dig):
        if signed:
            points, dig = _apply_signs(points, dig)
            nb = n_buckets(c)
        else:
            nb = 1 << c
        if affine and len(points) != 2:
            raise ValueError("window_program(affine=True) takes affine "
                             f"(X, Y) bases, got {len(points)} coordinates")
        buckets = bucket_fn(points, dig, nb)
        nb_pad = -(-nb // 64) * 64 if nb >= 128 else nb
        return _weighted_bucket_reduce(_pad_buckets(buckets, nb_pad))

    return run


# ---------------------------------------------------------------------------
# The v2 window pipeline, batched over windows
# ---------------------------------------------------------------------------

def _window_v2(prec_rows: torch.Tensor, dig_signed: torch.Tensor,
               bases: torch.Tensor, c: int, group: str, K: int = CHUNK):
    """Bucket phase of every window: dig_signed (BW, n) signed digits,
    bases (BW,) row offsets into prec_rows.  K5 gathers the sorted,
    sign-applied rows itself.  Returns
      tails_m (3 x (rows, BW*M))  in-chunk partials at each chunk end
      tail    (3 x (rows, BW*nb)) in-chunk partial at each bucket's tail
                                  (zeros where the bucket is not `valid`)
      mb, needs_carry, valid (BW, nb); last_seg, first_seg (BW, M);
      collided (bool tensor)."""
    BW, n = dig_signed.shape
    nb = n_buckets(c)
    dev = dig_signed.device
    absd = dig_signed.abs()
    d_sorted, order = kern.digit_sort(absd, nb)
    s_sorted = torch.gather(dig_signed < 0, 1, order.to(torch.int64))
    idx = (order + n * s_sorted.to(torch.int32)
           + bases.to(torch.int32)[:, None])
    tails_m, tail, collided = kern.bucket_scan_rows(prec_rows, idx, d_sorted,
                                                    K, group, nb)
    last_seg = d_sorted[:, K - 1::K]
    first_seg = d_sorted[:, 0::K]
    b_ids = torch.arange(nb, dtype=torch.int32, device=dev).expand(BW, nb)
    b_ids = b_ids.contiguous()
    pos = torch.searchsorted(d_sorted, b_ids, right=True) - 1
    posc = pos.clamp(0, n - 1)
    valid = (pos >= 0) & (torch.gather(d_sorted, 1, posc) == b_ids)
    mb = posc // K
    start = torch.searchsorted(d_sorted, b_ids, right=False)
    needs_carry = valid & (start < mb * K)
    return (tails_m, tail, mb, needs_carry, valid, last_seg, first_seg,
            collided.any())


def _assemble_buckets_batched(outs, n_windows: int, nb: int, M: int,
                              group: str) -> C.Point:
    """Cross-window completion of _window_v2: one segmented carry scan
    over all windows' chunk partials, then one K2 carry add -> (coord..,
    W*nb) buckets.  Bucket d of window w takes the carry into its tail's
    chunk where that bucket starts in an earlier chunk; K5 left its tail
    zero (infinity) where window w has no digit d."""
    tails_m, tail, mb, needs_carry, _valid, last_seg, first_seg = outs[:7]
    dev = mb.device
    tails_flat = tuple(_to_curve(v, group) for v in tails_m)
    wid = torch.arange(n_windows, dtype=torch.int32, device=dev)[:, None]
    seg_flat = (wid * (nb + 1) + last_seg).reshape(-1)
    car = _seg_scan_auto(tails_flat, seg_flat)
    match = torch.zeros((n_windows, M), dtype=torch.bool, device=dev)
    match[:, 1:] = last_seg[:, :-1] == first_seg[:, 1:]
    chunk = (wid * M + mb).to(torch.int32)              # (W, nb) flat chunk
    take = needs_carry & match.reshape(-1)[chunk.to(torch.int64)]
    tail_c = tuple(_to_curve(v, group) for v in tail)
    return kern.point_add_carry(tail_c, car, _carry_index(take, chunk))


def _wreduce_batched(v: C.Point, nblk: int, per: int,
                     K: int = CHUNK) -> Tuple[C.Point, C.Point]:
    """Batched weighted reduction of nblk bucket blocks laid out side by
    side, per % K == 0.  Returns (W, S) of width nblk: W_j = sum_b b*v_b
    (local b in [0, per)) and S_j = sum_b v_b.  One K6 launch per level:
    sum_b b*v_b = sum_m w_m + K * sum_m m*s_m, recursing on the stacked
    w and s chunk sums."""
    s, w = kern.weighted_chunk_sums(v, K)
    m_per = per // K
    if m_per == 1:
        return w, s
    m_pad = -(-m_per // K) * K
    stacked = tuple(torch.cat([_pad_blocks(a, nblk, m_per, m_pad),
                               _pad_blocks(b, nblk, m_per, m_pad)], dim=-1)
                    for a, b in zip(w, s))
    inner_w, inner_s = _wreduce_batched(stacked, 2 * nblk, m_pad, K)
    sum_w = tuple(x[..., :nblk] for x in inner_s)
    ws_s = tuple(x[..., nblk:] for x in inner_w)
    sum_s = tuple(x[..., nblk:] for x in inner_s)
    ws_s = C.point_double_n(ws_s, K.bit_length() - 1)
    return C.point_add(sum_w, ws_s), sum_s


def _combine_windows(stacked: C.Point, c: int, n_windows: int,
                     n_msm: int = 1) -> C.Point:
    """Per-window sums (n_msm blocks of n_windows, low window first) ->
    one point per MSM: window w doubled c*w times (one K2 launch), then
    the per-block sums."""
    dev = stacked[0].device
    counts = c * torch.arange(n_windows, dtype=torch.int32,
                              device=dev).repeat(n_msm)
    p = C.point_double_n(stacked, counts)
    if n_msm == 1:
        return _total_auto(p)
    seg = torch.repeat_interleave(
        torch.arange(n_msm, dtype=torch.int32, device=dev), n_windows)
    sc = _hs_segmented_scan(p, seg)
    return tuple(v[..., n_windows - 1::n_windows] for v in sc)


# Padded widths: MSMs take at least two scan chunks of CHUNK (every MSM
# takes the v2 path); fixed-base batches pad as the JAX package does, to
# at least 16 (`_fixed_base_std`).
MSM_MIN_LOG = 6
FB_MIN_LOG = 4


def padded_width(n: int, min_log: int = MSM_MIN_LOG) -> int:
    """A power of two, at least n and 2^min_log."""
    return 1 << max(min_log, (n - 1).bit_length())


def _check_width(n: int) -> None:
    if n % CHUNK or n < 2 * CHUNK:
        raise ValueError(f"MSM width {n} must be a multiple of {CHUNK} and "
                         f">= {2 * CHUNK}: pad with infinity")


def _msm_fused_impl(precs, dig_blocks, bases, n_msm: int, c: int,
                    group: str):
    """B MSMs (dig_blocks: B*W rows of signed digits) -> batch-B point and
    the collided flag (a tensor; True means some mixed add in K5 hit the
    doubling case and the result is garbage)."""
    BW, n = dig_blocks.shape
    W = BW // n_msm
    nb = n_buckets(c)
    nbp = -(-nb // CHUNK) * CHUNK
    outs = _window_v2(precs, dig_blocks, bases, c, group)
    buckets = _assemble_buckets_batched(outs, BW, nb, n // CHUNK, group)
    buckets = tuple(_pad_blocks(v, BW, nb, nbp) for v in buckets)
    totals, _ = _wreduce_batched(buckets, BW, nbp)
    return _combine_windows(totals, c, W, n_msm), outs[7]


def _bucket_phase_safe(precs, dig_blocks, bases, c: int, group: str) -> C.Point:
    """Collision-safe bucket sums with general adds (K2): sort, log-depth
    segmented scan, scatter of the segment tails."""
    BW, n = dig_blocks.shape
    nb = n_buckets(c)
    dev = dig_blocks.device
    absd = dig_blocks.abs()
    d_sorted, order = kern.digit_sort(absd, nb)
    order = order.to(torch.int64)
    sign = torch.gather(dig_blocks < 0, 1, order).to(torch.int64)
    g = precs[(order + n * sign + bases[:, None]).reshape(-1)]
    R = g.shape[1]
    X = _to_curve(g[:, :R // 2].t().contiguous(), group)
    Y = _to_curve(g[:, R // 2:].t().contiguous(), group)
    wid = torch.arange(BW, dtype=torch.int32, device=dev)[:, None]
    seg = (wid * (nb + 1) + d_sorted).reshape(-1)
    scanned = _hs_segmented_scan(C.affine_to_jac((X, Y)), seg)
    is_tail = torch.ones_like(seg, dtype=torch.bool)
    is_tail[:-1] = seg[:-1] != seg[1:]
    tgt = (wid.to(torch.int64) * nb + d_sorted).reshape(-1)[is_tail]
    buckets = C.infinity(group, BW * nb, dev)
    for b, s in zip(buckets, scanned):
        b[..., tgt] = s[..., is_tail]
    return buckets


def _msm_safe_core(precs, dig_blocks, bases, n_msm: int, c: int,
                   group: str) -> C.Point:
    BW = dig_blocks.shape[0]
    nb = n_buckets(c)
    nbp = -(-nb // CHUNK) * CHUNK
    buckets = _bucket_phase_safe(precs, dig_blocks, bases, c, group)
    buckets = tuple(_pad_blocks(v, BW, nb, nbp) for v in buckets)
    totals, _ = _wreduce_batched(buckets, BW, nbp)
    return _combine_windows(totals, c, BW // n_msm, n_msm)


@functools.lru_cache(maxsize=32)
def _row_offsets(pmap: tuple, n: int, W: int, device: str) -> torch.Tensor:
    """(B W,) int32: the first row of MSM j's table in the row tables, for
    each of its W digit blocks.  Cached, so that a prove makes no copy to
    the card (a pageable copy waits for the card) to build it."""
    return torch.tensor([p * 2 * n for p in pmap for _ in range(W)],
                        dtype=torch.int32, device=device)


def _digit_blocks(tables, S: torch.Tensor, pmap, c: int, mont: bool):
    """Row tables, signed digit blocks (B*W, n) (one K9 launch) and
    per-block table row offsets of a batch of MSMs; S is (B, 8, n),
    Montgomery where `mont`, else standard form."""
    n = tables[0][0].shape[-1]
    rows = [_prep_rows(t) for t in tables]
    precs = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
    dig_blocks = kern.signed_digits(S, c, mont=mont)
    W = dig_blocks.shape[0] // S.shape[0]
    bases = _row_offsets(tuple(pmap), n, W, str(S.device))
    return precs, dig_blocks, bases


def _msm_safe_impl(tables, S, pmap, c: int, group: str,
                   mont: bool) -> C.Point:
    """Collision-safe batch of MSMs; run only when the fused one collided."""
    precs, dig_blocks, bases = _digit_blocks(tables, S, pmap, c, mont)
    return _msm_safe_core(precs, dig_blocks, bases, len(pmap), c, group)


def _launch(tables, S: torch.Tensor, pmap, group: str, c, mont: bool):
    """The launch behind both public entries (S as `_digit_blocks` takes
    it): the whole batch enqueued; -> resolve()."""
    n = tables[0][0].shape[-1]
    _check_width(n)
    if c is None:
        c = auto_window(n)
    precs, dig_blocks, bases = _digit_blocks(tables, S, pmap, c, mont)
    util.annotate(c=c, windows=dig_blocks.shape[0] // len(pmap))
    res, col = _msm_fused_impl(precs, dig_blocks, bases, len(pmap), c, group)

    def resolve():
        if bool(col):
            with util.stage("zk.msm.safe_rerun", group=group,
                            msms=len(pmap)):
                return _msm_safe_impl(tables, S, pmap, c, group, mont)
        return res

    return resolve


def msm_many_staged_deferred(tables, scalars_mont_list, pmap,
                             group: str = "g1", c: int = None):
    """B MSMs against T shared affine tables (each width n), MSM j using
    tables[pmap[j]] and Montgomery scalars scalars_mont_list[j] (8, n).
    Launches the whole batch and returns `resolve()`, which reads the
    collision flag (one host sync) and re-runs the safe path if it is set;
    it returns the batch-B point."""
    return _launch(tables, torch.stack(list(scalars_mont_list)), pmap,
                   group, c, mont=True)


def _msm_jacobian(points: C.Point, scalars_std: torch.Tensor, group: str,
                  c: int) -> C.Point:
    """One MSM of Jacobian bases: the window program's log-depth K2 scan
    (`window_program(chunked=False, affine=False)`) over every window of
    the signed digits, then the window combine."""
    digits = _scalars_to_signed_windows(scalars_std, c)
    run = window_program(group, c, chunked=False, affine=False)
    sums = [run(points, digits[w]) for w in range(digits.shape[0])]
    stacked = tuple(torch.cat([s[i] for s in sums], dim=-1) for i in range(3))
    return _combine_windows(stacked, c, digits.shape[0])


def msm_staged_deferred(points, scalars_std: torch.Tensor,
                        group: str = "g1", c: int = None):
    """One MSM with standard-form scalars; returns `resolve()` yielding the
    batch-1 point.  Affine (X, Y) bases take the v2 pipeline as a batch of
    one (see msm_many_staged_deferred).  Jacobian (X, Y, Z) bases take
    `_msm_jacobian`, whose general adds resolve the degenerate cases in
    the formula: it never collides, and `resolve()` re-dispatches
    nothing."""
    if len(points) != 3:
        return _launch((points,), scalars_std.contiguous()[None], (0,),
                       group, c, mont=False)
    if c is None:
        c = auto_window(points[0].shape[-1])
    res = _msm_jacobian(points, scalars_std, group, c)
    return lambda: res


def msm_staged_device(points, scalars_std: torch.Tensor, group: str = "g1",
                      c: int = None) -> C.Point:
    """One MSM (`msm_staged_deferred`, resolved) -> the batch-1 point on
    the bases' device."""
    return msm_staged_deferred(points, scalars_std, group, c)()


def msm_many_staged_device(tables, scalars_mont_list, pmap,
                           group: str = "g1", c: int = None) -> C.Point:
    """B MSMs (`msm_many_staged_deferred`, resolved) -> the batch-B point
    on the tables' device."""
    return msm_many_staged_deferred(tables, scalars_mont_list, pmap,
                                    group, c)()


def msm_staged(points, scalars_std: torch.Tensor, group: str = "g1",
               c: int = None):
    """One MSM (`msm_staged_deferred`) -> a golden point on the host."""
    res = msm_staged_device(points, scalars_std, group, c)
    return (C.unpack_g1 if group == "g1" else C.unpack_g2)(res)[0]


# ---------------------------------------------------------------------------
# The whole MSM of the JAX package's `msm_g1` / `msm_g2` (`_msm_impl`):
# unsigned windows, each window's `_bucket_sums` then
# `_weighted_bucket_reduce`, Horner from the top window.  Collision-safe
# (general adds only), so it takes Jacobian bases and any width; the
# term-sharded MSM (`parallel/sharded.py`) runs its window sums on each
# rank's terms.
# ---------------------------------------------------------------------------

def _window_buckets(points: C.Point, digits: torch.Tensor,
                    n_buckets: int) -> C.Point:
    """`_bucket_sums` of every window at once: (W, N) digits -> (coord..,
    W*n_buckets) bucket sums, window w's at columns [w*nb, (w+1)*nb).  One
    stable sort of the rows, one gather of the W*N sorted points, the
    Hillis-Steele rounds of a window (log2 N, each one K2 add of all W*N
    lanes, segments by window and digit) and one scatter of the tails."""
    W, n = digits.shape
    dev = digits.device
    d_sorted, order = torch.sort(digits, dim=-1, stable=True)
    pts = tuple(x[..., order.reshape(-1)] for x in points)
    wid = torch.arange(W, dtype=torch.int64, device=dev)[:, None]
    seg = (wid * n_buckets + d_sorted).reshape(-1)
    return _scatter_tails(_hs_segmented_scan(pts, seg, span=n), seg,
                          W * n_buckets)


def _window_reduce(buckets: C.Point, n_windows: int, K: int = 64) -> C.Point:
    """`_weighted_bucket_reduce` of n_windows blocks of B buckets side by
    side -> n_windows points: sum_{b>=1} b S_b of each block as the sum of
    its suffix sums, every scan segmented by block.  Chunked (K7, K2) where
    B is a multiple of K with at least two chunks, as the JAX function
    chooses, else the log-depth K2 scans."""
    width = buckets[0].shape[-1]
    B = width // n_windows
    dev = buckets[0].device
    pos = torch.arange(width, device=dev)
    col = pos % B
    seg = (pos // B).to(torch.int32)
    inf = C.infinity(_group(buckets), width, dev)
    # the weight of S_0 is 0; the blocks reversed: rev[k] = S_{B-1-k}
    flip = pos - col + (B - 1 - col)
    rev = tuple(kern.select_lanes(col == 0, i, v)[..., flip]
                for i, v in zip(inf, buckets))
    chunked = B % K == 0 and B // K >= 2

    def scan(p):
        if chunked:
            return _seg_scan_auto(p, seg, K)
        return _hs_segmented_scan(p, seg, span=B)

    sc = scan(rev)                                       # T_{B-1-k}
    last = col == B - 1
    sc = tuple(kern.select_lanes(last, i, v) for i, v in zip(inf, sc))
    return tuple(v[..., B - 1::B] for v in scan(sc))     # drop T_0, sum


def _window_sums(points: C.Point, digits: torch.Tensor, c: int) -> C.Point:
    """Each window's weighted bucket sum, W points (low window first):
    (W, N) unsigned digits of c bits over Jacobian bases."""
    n_windows = digits.shape[0]
    return _window_reduce(_window_buckets(points, digits, 1 << c), n_windows)


def _horner_windows(wsums: C.Point, c: int) -> C.Point:
    """Per-window sums (low window first) -> their combination by Horner,
    high to low: acc = 2^c acc + W_w (one K2 doubling launch of count c
    and one K2 add a window)."""
    W = wsums[0].shape[-1]
    acc = tuple(v[..., W - 1:] for v in wsums)
    for w in range(W - 2, -1, -1):
        acc = C.point_add(C.point_double_n(acc, c),
                          tuple(v[..., w:w + 1] for v in wsums))
    return acc


def _msm_impl(points, scalars_std: torch.Tensor, c: int) -> C.Point:
    if len(points) == 2:
        points = C.affine_to_jac(points)
    return _horner_windows(
        _window_sums(points, _scalars_to_windows(scalars_std, c), c), c)


def msm_g1(points, scalars_std: torch.Tensor, c: int = 8) -> C.Point:
    """The whole G1 MSM of the JAX package's `msm_g1`: affine (X, Y) or
    Jacobian bases, (8, N) standard-form scalars, unsigned windows of c
    bits -> the batch-1 point on the bases' device."""
    return _msm_impl(points, scalars_std, c)


def msm_g2(points, scalars_std: torch.Tensor, c: int = 8) -> C.Point:
    """`msm_g1` over G2."""
    return _msm_impl(points, scalars_std, c)


# ---------------------------------------------------------------------------
# Fixed-base batches
# ---------------------------------------------------------------------------

def _fixed_base_table_device(group: str, c: int, device) -> C.AffinePoint:
    """Window table, affine: entry [w * 2^c + d] = d * 2^(cw) * G.  The W
    window bases come from host doublings; each block of multiples is one
    segmented prefix scan (K7) of the repeated base, shifted by one and
    batch-normalized to affine ((0, 0) at d = 0)."""
    gen = G1.generator() if group == "g1" else G2.generator()
    n_windows = -(-256 // c)
    per = 1 << c
    bases, b = [], gen
    for _ in range(n_windows):
        bases.append(b)
        for _ in range(c):
            b = b.double()
    pack = C.pack_g1 if group == "g1" else C.pack_g2
    rep = tuple(torch.repeat_interleave(x, per, dim=-1)
                for x in pack(bases, device))
    seg = torch.repeat_interleave(
        torch.arange(n_windows, dtype=torch.int32, device=device), per)
    sc = _seg_scan_auto(rep, seg)                 # (d+1) * B_w at position d
    t = tuple(_shift1(x) for x in sc)
    starts = (torch.arange(n_windows * per, device=device) % per) == 0
    tz = kern.select_lanes(starts, torch.zeros_like(t[2]), t[2])
    return C.to_affine((t[0], t[1], tz))


@functools.lru_cache(maxsize=8)
def fixed_base_table_device(group: str, c: int, device) -> C.AffinePoint:
    """The window table for (group, c), built once per process and device."""
    return _fixed_base_table_device(group, c, torch.device(device))


# Batches from this size take the rows path (K5); smaller ones the window
# loop of K3 mixed adds, as in the JAX package (`msm.py:1302-1314`).
_FB_ROWS_MIN = 128


def fixed_base_mul(scalars_std: torch.Tensor, group: str = "g1", c: int = 8,
                   table: C.AffinePoint = None) -> C.Point:
    """[g * s for s in scalars] from the affine window table: from 128
    elements, K5 over the table's rows, one segment per element (chunk =
    W windows); below, W - 1 K3 mixed adds of each window's table entry
    into the running sum."""
    dev = scalars_std.device
    if table is None:
        table = fixed_base_table_device(group, c, str(dev))
    tX, tY = table
    digits = _scalars_to_windows(scalars_std, c)      # (W, n)
    if digits.shape[1] >= _FB_ROWS_MIN:
        return _fixed_base_rows(tX, tY, digits, c, group)
    return _fixed_base_madd(tX, tY, digits, c)


def _fixed_base_madd(tX, tY, digits: torch.Tensor, c: int) -> C.Point:
    """The window loop as one K3 chain launch: acc = T[0][d_0], then acc +=
    T[w][d_w] for w = 1..W-1, the kernel gathering T[w 2^c + d_w] itself;
    zero digits fetch the (0, 0) entry (infinity)."""
    return kern.point_madd_chain((tX, tY), digits.shape[0],
                                 digits.to(torch.int32).contiguous(), c)


def _fixed_base_rows(tX, tY, digits: torch.Tensor, c: int,
                     group: str) -> C.Point:
    """Fixed-base batch via the row-layout scan (K5): element e's W window
    points are chunk e, one segment per chunk, so the chunk's final
    accumulator is the element's sum.  A partial sum over the low windows
    is below 2^(cw) times G while the next window's point is a nonzero
    multiple of 2^(cw) G, so the doubling case of the mixed add cannot
    occur; zero digits fetch the (0, 0) entry (infinity)."""
    rows = torch.cat([_flat(tX), _flat(tY)], dim=0).t().contiguous()
    W = digits.shape[0]
    offs = torch.arange(W, dtype=torch.int32, device=digits.device) << c
    idx = (digits.t() + offs[None, :]).contiguous()       # (m, W)
    tails, _, _ = kern.bucket_scan_rows(rows, idx, None, W, group)
    return tuple(_to_curve(v, group) for v in tails)


def powers_of(s: int, d: int, device=None) -> torch.Tensor:
    """[s^0..s^d] standard form, packed (8, d+1); host-side (d modmuls)."""
    out, acc = [], 1
    for _ in range(d + 1):
        out.append(acc)
        acc = acc * s % FR.p
    return F.pack(out, FR, device)


def g_powers(s: int, d: int, group: str = "g1", device=None,
             c: int = 8) -> C.Point:
    """{g^(s^i)}_{i in [0..d]} (curve.ml:106-109) as one fixed-base batch."""
    return fixed_base_mul(powers_of(s, d, device), group=group, c=c)
