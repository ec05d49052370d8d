"""Distributed MSM / NTT / witness evaluation over a torch.distributed group.

Counterpart of `zukelang_tpu/parallel/sharded.py`, whose programs are
`shard_map`s over a 1-D JAX mesh.  Here every rank of a process group
runs the same function on its shard (SPMD), and the collectives are the
ones the JAX programs name: NCCL on the card, gloo on the CPU (the
tests).  The public functions take what the JAX ones take: replicated
global tensors, a CRS or proving key, the witness; each rank slices its
own shard.  A value the caller reads whole (MSM points, proofs, the
witness reduction's (a, b, h)) comes back replicated on every rank;
`sharded_ntt`, `sharded_intt`, `sharded_gate_eval` and
`sharded_fixed_base` return this rank's block, which `Mesh.gather`
assembles.

  * MSM: points and scalars split into contiguous term blocks; each rank
    runs every window's bucket sums and weighted reduce on its block
    (`msm._window_sums`: the JAX package's `_bucket_sums` and
    `_weighted_bucket_reduce` of each window, all windows at once), ONE
    all_gather collects the (D, W) window partials, and every rank folds
    the device axis (one segmented Hillis-Steele scan) and combines the
    windows (`msm._combine_windows`).
  * NTT: the four-step scheme on (nl, N1, N2) split on N2: the column
    NTTs of the rank's N2/D columns as one batched transform (the NTT
    kernel), the twiddle product (K1), ONE all_to_all that resplits on
    N1, the row NTTs as one more batched transform.  The output is
    (nl, N2, N1) split on N1, the JAX layout.
  * Witness reduction: the gates evaluated where the first transform
    needs them (K1, `field.add`), three four-step transforms of three
    vectors each (iNTT; coset NTT; iNTT of h) with the coset scales and
    the pointwise quotient on K1 in the shard's own layout; when log2 N
    is odd the two splits differ, and one all_to_all moves the vectors
    from one transform's output split to the next one's input split.
    One all_gather returns (a, b, h) whole.
  * Groth16 / Pinocchio proves: the sharded witness reduction, then the
    MSMs the protocol states (`groth16_device.msms`,
    `pinocchio_device.msms`, which the single-card `device.prove` runs
    too) each term-sharded, then the protocol's own proof from the sums
    (`groth16_device.assemble_proof`, `pinocchio_device.proof_of_sums`).

`Mesh.counts` counts each collective and the bytes each rank hands to it.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import params
from ..engine import torch_engine as te
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..ops import ntt as ntt_mod
from ..params import FR
from ..protocols import device as steps
from ..protocols import groth16_device as gd
from ..protocols import pinocchio_device as pd

COLLECTIVES = ("all_gather", "all_to_all")


def _new_counts() -> dict:
    return {k: 0 for c in COLLECTIVES for k in (c, c + "_bytes")}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group: this rank's index, their number and
    this rank's device.  `counts` holds the collectives run on it and the
    bytes this rank handed to them."""
    group: object
    rank: int
    size: int
    device: torch.device
    counts: dict = dataclasses.field(default_factory=_new_counts,
                                     compare=False, hash=False)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n items (n divisible by size)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def _count(self, what: str, t: torch.Tensor) -> None:
        self.counts[what] += 1
        self.counts[what + "_bytes"] += t.numel() * t.element_size()

    def all_gather(self, x: torch.Tensor) -> list:
        """[rank 0's x, ..., rank D-1's x] (one all_gather)."""
        x = x.contiguous()
        self._count("all_gather", x)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor, out_splits=None,
                   in_splits=None) -> torch.Tensor:
        """Rows of x (dim 0) sent in rank order, in_splits rows to each
        rank (default equal); -> the rows received, out_splits from each
        rank in rank order (one all_to_all)."""
        x = x.contiguous()
        self._count("all_to_all", x)
        rows = x.shape[0] if out_splits is None else sum(out_splits)
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, out_splits, in_splits,
                               group=self.group)
        return out

    def gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The whole of a tensor split along `axis` into rank blocks."""
        return torch.cat(self.all_gather(x), dim=axis)

    def sync(self) -> None:
        """Wait for this rank's device (its queued kernels and
        collectives)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_mesh(n_devices: int = None, device=None) -> Mesh:
    """The first n_devices ranks (default all) of the initialised default
    process group.  `device` None or "cuda" asks for NCCL, each rank on
    cuda:<local rank>; "cpu" for gloo.  Raises where CUDA is asked for and
    missing, where the group's backend is not the one asked for, or where
    an NCCL world has more ranks than the host has cards; ranks beyond
    n_devices get None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: needs a CUDA device (pass "
                           "device='cpu' for gloo on the CPU)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start one with "
                           "parallel.launch (spawn, init_world1) or torchrun")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"make_mesh: the group runs {backend}, {dev.type} "
                           f"asks for {want}")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks of a world of {world}")
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: a world of {world} ranks on "
                               f"{torch.cuda.device_count()} cards")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local)
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, rank, n, dev) if rank < n else None


# ---------------------------------------------------------------------------
# Term-sharded MSM (G1 over Fq, G2 over Fq2)
# ---------------------------------------------------------------------------

def _unpack(group: str):
    return C.unpack_g1 if group == "g1" else C.unpack_g2


def _to_jac(points) -> C.Point:
    return points if len(points) == 3 else C.affine_to_jac(points)


def _gather_points(mesh: Mesh, points: C.Point) -> torch.Tensor:
    """One all_gather of a point batch -> (3, coord.., D, width)."""
    return torch.stack(mesh.all_gather(torch.stack(points)), dim=-2)


def sharded_msm_window(mesh: Mesh, points, digits: torch.Tensor,
                       c: int = 8, group: str = "g1") -> C.Point:
    """One Pippenger window (digits (N,) of c bits) with the terms split
    over the ranks: each rank's bucket sums and weighted reduce, the D
    partials all_gathered and folded -> the batch-1 point, replicated."""
    sl = mesh.block(digits.shape[-1])
    pts = _to_jac(tuple(v[..., sl] for v in points))
    partial = msm_mod._weighted_bucket_reduce(
        msm_mod._bucket_sums(pts, digits[sl], 1 << c))
    g = _gather_points(mesh, partial)
    return msm_mod._hs_total(tuple(g.flatten(-2).unbind(0)))


def sharded_msm_device(mesh: Mesh, points, scalars_std: torch.Tensor,
                       group: str = "g1", c: int = 8,
                       max_windows: int = None) -> C.Point:
    """The whole MSM with the terms split over the ranks: affine (X, Y) or
    Jacobian bases and (8, N) standard-form scalars, replicated; -> the
    batch-1 Jacobian point, replicated.  `max_windows` keeps the low
    windows only: the MSM of the scalars' low c * max_windows bits."""
    sl = mesh.block(scalars_std.shape[-1])
    digits = msm_mod._scalars_to_windows(scalars_std[:, sl], c)
    if max_windows is not None:
        digits = digits[:max_windows]
    W, D = digits.shape[0], mesh.size
    ws = msm_mod._window_sums(_to_jac(tuple(v[..., sl] for v in points)),
                              digits, c)
    # one collective: (3, .., D, W), then window-major (.., W*D)
    g = _gather_points(mesh, ws).transpose(-1, -2).flatten(-2)
    seg = torch.arange(W, dtype=torch.int32,
                       device=g.device).repeat_interleave(D)
    sc = msm_mod._hs_segmented_scan(tuple(g.unbind(0)), seg)
    tails = tuple(v[..., D - 1::D] for v in sc)
    return msm_mod._combine_windows(tails, c, W)


def sharded_msm(mesh: Mesh, points, scalars_std: torch.Tensor,
                group: str = "g1", c: int = 8, max_windows: int = None):
    """`sharded_msm_device` -> a golden G1 / G2 point on every rank."""
    return _unpack(group)(sharded_msm_device(mesh, points, scalars_std,
                                             group, c, max_windows))[0]


def sharded_msm_g1(mesh: Mesh, points, scalars_std: torch.Tensor,
                   c: int = 8, max_windows: int = None):
    return sharded_msm(mesh, points, scalars_std, "g1", c, max_windows)


def sharded_fixed_base(mesh: Mesh, scalars_std: torch.Tensor,
                       group: str = "g1", c: int = 8) -> C.Point:
    """[g * s for s in scalars] of this rank's block of the scalars (no
    collective): the rank's block of the batch, the layout the
    term-sharded MSM reads."""
    sl = mesh.block(scalars_std.shape[-1])
    return msm_mod.fixed_base_mul(scalars_std[:, sl], group=group, c=c)


# ---------------------------------------------------------------------------
# Four-step distributed NTT
# ---------------------------------------------------------------------------
# Layouts of this rank r's share of S vectors of N = N1 N2 (c2 = N2/D,
# n1d = N1/D), limbs first so that K1 reads them as they lie:
#   input  (nl, S, c2, N1):  [.., i2l, i1]  holds natural i1 N2 + r c2 + i2l
#   output (nl, S, n1d, N2): [.., k1l, k2]  holds natural k2 N1 + r n1d + k1l
# (the transform's X[k1 + N1 k2] at [.., k1l, k2]).  With N1 == N2 one
# transform's output is the next one's input as it lies.

@functools.lru_cache(maxsize=16)
def _twiddle_matrix(log1: int, log2: int, inverse: bool) -> np.ndarray:
    """(nl, N1, N2) uint32 Montgomery limbs of w_N^(i j), w the (inverse)
    2^(log1 + log2)-th root; built once a shape on the host."""
    n1, n2 = 1 << log1, 1 << log2
    w = ntt_mod.root_for(log1 + log2, inverse)
    r = params.R
    vals = []
    for i in range(n1):
        wi, acc = pow(w, i, r), FR.R % r
        for _ in range(n2):
            vals.append(acc)
            acc = acc * wi % r
    return F._np_limbs(vals, FR.nl).reshape(FR.nl, n1, n2)


@functools.lru_cache(maxsize=32)
def _twiddle_block(log1: int, log2: int, inverse: bool, size: int,
                   rank: int, device: str) -> torch.Tensor:
    """This rank's columns of the twiddle matrix, (nl, 1, c2, N1)."""
    c2 = (1 << log2) // size
    blk = _twiddle_matrix(log1, log2, inverse)[:, :, rank * c2:(rank + 1) * c2]
    return F._as_tensor(np.ascontiguousarray(blk.transpose(0, 2, 1)),
                        device)[:, None]


def _mul_each(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """K1 product of (nl, S, ...) vectors with one (nl, 1, ...) table."""
    return F.mont_mul(x, t.expand(x.shape).contiguous(), FR)


def _four_step(mesh: Mesh, x: torch.Tensor, log1: int, log2: int,
               inverse: bool, clock=None) -> torch.Tensor:
    """S transforms of this rank's input block x (nl, S, c2, N1) -> its
    output block (nl, S, n1d, N2).  `clock(phase)`, if given, is called at
    the end of each phase ("col", "twiddle", "all_to_all", "row")."""
    nl, S, c2, n1 = x.shape
    D, n2 = mesh.size, 1 << log2
    n1d = n1 // D
    tick = clock or (lambda _phase: None)
    # column NTTs: S * c2 vectors of N1, one batched transform
    y = ntt_mod.ntt(x.permute(1, 2, 0, 3).reshape(S * c2, nl, n1), inverse)
    tick("col")
    y = y.view(S, c2, nl, n1).permute(2, 0, 1, 3)
    y = _mul_each(y, _twiddle_block(log1, log2, inverse, D, mesh.rank,
                                    str(mesh.device)))
    tick("twiddle")
    # resplit from N2 columns to N1 rows: block j of each row to rank j
    send = y.view(nl, S, c2, D, n1d).permute(3, 0, 1, 2, 4)
    recv = mesh.all_to_all(send)                 # [k, limb, s, i2l, k1l]
    tick("all_to_all")
    z = recv.permute(2, 4, 1, 0, 3).reshape(S * n1d, nl, n2)
    z = ntt_mod.ntt(z, inverse)                  # row NTTs: S * n1d of N2
    out = z.view(S, n1d, nl, n2).permute(2, 0, 1, 3).contiguous()
    tick("row")
    return out


def _check_split(mesh: Mesh, log1: int, log2: int) -> None:
    if (1 << log1) % mesh.size or (1 << log2) % mesh.size:
        raise ValueError(f"four-step NTT 2^{log1} x 2^{log2} does not split "
                         f"over {mesh.size} ranks")


def sharded_ntt(mesh: Mesh, x: torch.Tensor, log1: int, log2: int,
                inverse: bool = False) -> torch.Tensor:
    """Four-step NTT of a replicated (nl, N1, N2) coefficient array (the
    row-major view of a length N1 N2 vector: coeff[i1 N2 + i2] =
    x[:, i1, i2]), split on N2 -> this rank's (nl, N2, N1/D) block of the
    evaluations in transposed (nl, N2, N1) layout, split on N1: out[:, k2,
    k1] = X[k1 + N1 k2]."""
    _check_split(mesh, log1, log2)
    sl = mesh.block(1 << log2)
    blk = x[:, :, sl].transpose(1, 2)[:, None].contiguous()
    out = _four_step(mesh, blk, log1, log2, inverse)
    return out[:, 0].transpose(1, 2).contiguous()


def sharded_intt(mesh: Mesh, x: torch.Tensor, log1: int,
                 log2: int) -> torch.Tensor:
    """Inverse NTT of a replicated (nl, N) batch by the four-step scheme ->
    this rank's (nl, N2, N1/D) block; gathered along axis 2 and flattened
    it is the coefficients in natural order."""
    nl, n = x.shape
    return sharded_ntt(mesh, x.reshape(nl, 1 << log1, 1 << log2), log1, log2,
                       inverse=True)


def sharded_ntt_phase_times(mesh: Mesh, x: torch.Tensor, log1: int,
                            log2: int, inverse: bool = False,
                            repeats: int = 3) -> dict:
    """Seconds of the four phases of `sharded_ntt` inside one run, the
    card synchronised at each phase boundary (a warm-up run first; the
    run of the least total of `repeats`): col_ntt_s, twiddle_s,
    all_to_all_s, row_ntt_s, total_s."""
    _check_split(mesh, log1, log2)
    sl = mesh.block(1 << log2)
    blk = x[:, :, sl].transpose(1, 2)[:, None].contiguous()
    best = None
    for rep in range(repeats + 1):
        marks = []

        def clock(phase):
            mesh.sync()
            marks.append((phase, time.perf_counter()))
        clock("start")
        _four_step(mesh, blk, log1, log2, inverse, clock)
        if rep and (best is None or marks[-1][1] - marks[0][1]
                    < best[-1][1] - best[0][1]):
            best = marks
    t = {p: b - a for (_q, a), (p, b) in zip(best, best[1:])}
    return {"col_ntt_s": t["col"], "twiddle_s": t["twiddle"],
            "all_to_all_s": t["all_to_all"], "row_ntt_s": t["row"],
            "total_s": best[-1][1] - best[0][1]}


# ---------------------------------------------------------------------------
# Gate-sharded witness / constraint evaluation
# ---------------------------------------------------------------------------

def _gate_eval(side, w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A side's ragged rows (offsets, cols, coef) + (nl, V+1) witness ->
    (nl, len(rows)) sums of the rows `rows`: the JAX engine's `_gate_eval`,
    K1 products of each row's terms added in term order."""
    return ntt_mod.gate_sums(side, w, rows,
                             mul=lambda a, b: F.mont_mul(a, b, FR))


def sharded_gate_eval(mesh: Mesh, side, witness: torch.Tensor
                      ) -> torch.Tensor:
    """Per-gate affine evaluation with the gate axis split and the witness
    replicated: a side's (offsets, cols, coef), (nl, V+1) witness -> this
    rank's (nl, G/D) block of the evaluations."""
    sl = mesh.block(side[0].shape[0] - 1)
    rows = torch.arange(side[0].shape[0] - 1, device=witness.device)[sl]
    return _gate_eval(side, witness, rows)


def sharded_prove_step(mesh: Mesh, fc_args, witness: torch.Tensor,
                       ti1, logn: int, max_windows: int = None):
    """A representative sharded prove step: gate-sharded evaluation of the
    l side -> the four-step inverse NTT -> the term-sharded G1 MSM (c = 4)
    over ti1.  Returns the golden point on every rank."""
    ev = mesh.gather(sharded_gate_eval(mesh, fc_args, witness), 1)
    n = 1 << logn
    log2 = max(1, logn // 2)
    log1 = logn - log2
    ev = torch.nn.functional.pad(ev, (0, n - ev.shape[1]))
    a = mesh.gather(sharded_intt(mesh, ev, log1, log2), 2).reshape(-1, n)
    return sharded_msm_g1(mesh, ti1, F.from_mont(a, FR), c=4,
                          max_windows=max_windows)


# ---------------------------------------------------------------------------
# Fully sharded witness reduction
# ---------------------------------------------------------------------------

def _split_logs(logn: int, n_dev: int) -> Tuple[int, int]:
    """N = N1 N2 for the four-step NTT with both factors divisible by the
    number of ranks (log1 >= log2)."""
    log_d = max(1, (n_dev - 1).bit_length())
    log2_ = max(log_d, logn // 2)
    log1_ = logn - log2_
    if log1_ < log_d:
        raise ValueError(f"domain 2^{logn} too small for a {n_dev}-rank "
                         "four-step NTT")
    return log1_, log2_


@functools.lru_cache(maxsize=64)
def _natural(log1: int, log2: int, size: int, rank: int,
             output: bool) -> np.ndarray:
    """Natural indices of this rank's input block (c2, N1), or output
    block (n1d, N2)."""
    n1, n2 = 1 << log1, 1 << log2
    if output:
        n1d = n1 // size
        return (np.arange(n2)[None, :] * n1 + rank * n1d
                + np.arange(n1d)[:, None])
    c2 = n2 // size
    return (np.arange(n1)[None, :] * n2 + rank * c2
            + np.arange(c2)[:, None])


@functools.lru_cache(maxsize=32)
def _layout_table(logn: int, log1: int, log2: int, size: int, rank: int,
                  output: bool, what: str, device: str) -> torch.Tensor:
    """(nl, 1, ..) table of one block layout: the coset powers g^i
    ("coset") or g^-i ("coset_inv") at the natural indices it holds."""
    idx = torch.from_numpy(_natural(log1, log2, size, rank,
                                    output).reshape(-1)).to(device)
    pw = ntt_mod._coset_powers(logn, what == "coset_inv", device)
    shape = _natural(log1, log2, size, rank, output).shape
    return pw[:, idx].reshape((FR.nl, 1) + shape)


@functools.lru_cache(maxsize=32)
def _reshard_plan(log1: int, log2: int, size: int, rank: int, device: str):
    """The one all_to_all from an output split to the next input split:
    (send order of this rank's output positions, rows to each rank, rows
    from each rank, input position of each received row)."""
    n1, n2 = 1 << log1, 1 << log2
    c2 = n2 // size
    m = [_natural(log1, log2, size, k, True).reshape(-1) for k in range(size)]
    t = [(mk % n2) // c2 for mk in m]
    send = np.argsort(t[rank], kind="stable")
    got = np.concatenate([mk[tk == rank] for mk, tk in zip(m, t)])
    pos = (got % n2 % c2) * n1 + got // n2
    return (torch.from_numpy(send).to(device),
            np.bincount(t[rank], minlength=size).tolist(),
            [int((tk == rank).sum()) for tk in t],
            torch.from_numpy(pos).to(device))


def _reshard(mesh: Mesh, x: torch.Tensor, log1: int,
             log2: int) -> torch.Tensor:
    """Output blocks (nl, S, n1d, N2) -> the next transform's input blocks
    (nl, S, c2, N1) of the same vectors: one all_to_all, where N1 != N2."""
    nl, S = x.shape[:2]
    send, in_splits, out_splits, pos = _reshard_plan(
        log1, log2, mesh.size, mesh.rank, str(mesh.device))
    rows = x.reshape(nl, S, -1)[:, :, send].permute(2, 0, 1)
    recv = mesh.all_to_all(rows, out_splits, in_splits)
    out = torch.empty_like(recv)
    out[pos] = recv
    return out.permute(1, 2, 0).reshape(nl, S, (1 << log2) // mesh.size,
                                        1 << log1)


def _gather_natural(mesh: Mesh, x: torch.Tensor, log1: int) -> torch.Tensor:
    """Output blocks (nl, S, n1d, N2) of every rank -> (nl, S, N) in natural
    order (one all_gather)."""
    nl, S, n1d, n2 = x.shape
    g = torch.stack(mesh.all_gather(x))          # [r, limb, s, k1l, k2]
    return g.permute(1, 2, 4, 0, 3).reshape(nl, S, n2 << log1)


def sharded_witness_reduction(mesh: Mesh, fc, witness_mont: torch.Tensor):
    """The witness reduction over the ranks: the gates evaluated where the
    first transform's input split holds them, three four-step transforms
    (iNTT of a, b, c; coset NTT; iNTT of h) with the coset scales and the
    pointwise quotient in the shard's layout.  Returns (a, b, h), (nl, N)
    Montgomery coefficients in natural order, replicated."""
    logn = fc.logn
    D, dev = mesh.size, mesh.device
    log1, log2 = _split_logs(logn, D)
    w = witness_mont.to(dev)
    nat = torch.from_numpy(_natural(log1, log2, D, mesh.rank,
                                    False).reshape(-1)).to(dev)
    evals = []
    for side in fc.sides:
        rows = te.side_tensors(side, dev)
        live = nat < side.n_gates
        ev = torch.zeros((FR.nl, nat.numel()), dtype=torch.int32, device=dev)
        ev[:, live] = _gate_eval(rows, w, nat[live])
        evals.append(ev)
    x = torch.stack(evals, 1).reshape(FR.nl, 3, (1 << log2) // D, 1 << log1)

    def to_input(y):
        return y if log1 == log2 else _reshard(mesh, y, log1, log2)

    def table(output, what):
        return _layout_table(logn, log1, log2, D, mesh.rank, output, what,
                             str(dev))

    abc = _four_step(mesh, x, log1, log2, True)
    cos = _four_step(mesh, _mul_each(to_input(abc), table(False, "coset")),
                     log1, log2, False)
    zinv = F.const_mont(ntt_mod.zh_on_coset_inv(logn), cos[0, 0].numel(),
                        FR, dev).reshape(cos[:, 0].shape)
    hc = F.mont_mul(F.sub(F.mont_mul(cos[:, 0], cos[:, 1], FR), cos[:, 2],
                          FR), zinv, FR)
    h = _mul_each(_four_step(mesh, to_input(hc[:, None]), log1, log2, True),
                  table(True, "coset_inv"))
    a, b, h = _gather_natural(mesh, torch.cat([abc[:, :2], h], 1),
                              log1).unbind(1)
    return a, b, h


# ---------------------------------------------------------------------------
# Fully sharded Groth16 / Pinocchio proves
# ---------------------------------------------------------------------------

def _sharded_msms(mesh: Mesh, fc, witness_mont: torch.Tensor, statement,
                  c: int):
    """A protocol's prove statement (`device.prove`'s) on the ranks: the
    sharded witness reduction, then `statement(w, (a, b, h))`'s MSMs each
    term-sharded, the scalars out of Montgomery form -> (G1 sums, G2
    sums), golden points in the statement's order, on every rank."""
    w = witness_mont.to(mesh.device)
    width, g1, g2 = statement(w, sharded_witness_reduction(mesh, fc, w))
    return tuple(
        [sharded_msm(mesh, steps.fit_points(t, width),
                     F.from_mont(steps.pad_scalars(s, width), FR), group,
                     c=c) for t, s in pairs]
        for group, pairs in (("g1", g1), ("g2", g2)))


def sharded_groth16_prove(mesh: Mesh, crs, fc, witness_mont: torch.Tensor,
                          rng, c: int = 4):
    """Groth16 prove on the ranks (groth16.ml:123-161): the sharded
    witness reduction, then `groth16_device.msms`' four G1 MSMs and G2 MSM
    term-sharded and `assemble_proof`.  Equal to
    `groth16_device.prove_device`'s proof under the same rng (r, then s);
    the same proof on every rank."""
    r_sc = rng.fr()
    s_sc = rng.fr()
    g1, g2 = _sharded_msms(mesh, fc, witness_mont,
                           functools.partial(gd.msms, crs), c)
    return gd.assemble_proof(crs, *g1, *g2, r_sc, s_sc)


def sharded_pinocchio_prove(mesh: Mesh, pkey, fc, witness_mont: torch.Tensor,
                            rng, zk: bool = True, c: int = 4):
    """Pinocchio prove on the ranks (pinocchio.ml:193-250 NonZK, :423-515
    ZK): the sharded witness reduction, then `pinocchio_device.msms`' 6 G1
    (8 with ZK) and 2 G2 MSMs term-sharded and `proof_of_sums` (with ZK
    the fold of the tail variables and the randomisation in the host
    library, `zk_fold`).  Equal to `pinocchio_device.prove_device`'s proof
    under the same rng (dv, dw, dy); the same proof on every rank."""
    tail = pd.tail_values(pkey, fc, witness_mont, zk)
    g1, g2 = _sharded_msms(mesh, fc, witness_mont,
                           functools.partial(pd.msms, pkey, fc, zk=zk), c)
    return pd.proof_of_sums(pkey, g1, g2, tail, rng, zk)
