"""The device provers' shared steps (`groth16_device`, `pinocchio_device`
and `parallel.sharded`).

A protocol states its prove's MSMs once, a function of the witness on the
device and the witness reduction's (a, b, h) -> (width, G1 pairs, G2
pairs), each pair a base table and its Montgomery scalars.  `prove` runs
it on one card (both batches launched, then resolved);
`parallel.sharded` runs it through the term-sharded MSM.  The prove's and
the keygens' shared spans are opened here.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .. import params, util
from ..engine import torch_engine as te
from ..golden.curve import G1, G2
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..params import FR


def pad_scalars(s: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or pad (with zeros) (8, m) scalars to width n."""
    cur = s.shape[1]
    return torch.nn.functional.pad(s, (0, n - cur)) if cur < n else s[:, :n]


def fit_points(p: C.AffinePoint, n: int) -> C.AffinePoint:
    """Truncate or pad (with the (0, 0) infinity marker) to width n."""
    cur = p[0].shape[-1]
    if cur >= n:
        return tuple(x[..., :n].contiguous() for x in p)
    return tuple(torch.nn.functional.pad(x, (0, n - cur)) for x in p)


def host_point(p):
    """A host point of either package -> this package's, through its
    compressed bytes (48 for G1, 96 for G2)."""
    raw = p.to_compressed_bytes()
    return (G1 if len(raw) == 48 else G2).of_compressed_bytes(raw)


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------

def prove(dev, fc, witness_mont: torch.Tensor, statement: Callable, c):
    """The witness copied to `dev`, the witness reduction
    (`te.run_witness_reduction`), then `statement(w, (a, b, h))` ->
    (width, G1 pairs, G2 pairs) run with MSM window c (None: by width):
    both batches launched, then each waited for and unpacked.  -> (G1
    sums, G2 sums), host points in the statement's order."""
    nbytes = (witness_mont.numel() * witness_mont.element_size()
              if witness_mont.device != dev else 0)
    with util.stage("zk.prove.witness_to_device", bytes=nbytes):
        w = witness_mont.to(dev)
    with util.stage("zk.prove.reduction", n=fc.domain_size, nnz=fc.nnz):
        red = te.run_witness_reduction(fc, w)
    # the statement's gathers and pads run inside the G1 launch; resolving
    # reads the collision flag, a host sync, so both batches launch first
    with util.stage("zk.prove.msm_launch", group="g1"):
        width, g1, g2 = _fitted(statement(w, red))
        g1_resolve = _launch(g1, width, "g1", c)
    with util.stage("zk.prove.msm_launch", group="g2"):
        g2_resolve = _launch(g2, width, "g2", c)
    with util.stage("zk.prove.msm_wait", group="g1"):
        g1_sums = g1_resolve()
    with util.stage("zk.prove.unpack", group="g1"):
        g1_pts = C.unpack_g1(g1_sums)
    with util.stage("zk.prove.msm_wait", group="g2"):
        g2_sums = g2_resolve()
    with util.stage("zk.prove.unpack", group="g2"):
        g2_pts = C.unpack_g2(g2_sums)
    return g1_pts, g2_pts


def _fitted(stated) -> tuple:
    """A statement's (width, G1 pairs, G2 pairs) with each distinct table
    and scalar tensor brought to the width once.  The stated tensors are
    not kept: a gathered column set goes once it is padded."""
    width, *batches = stated
    done = {}

    def once(x, fit):
        if id(x) not in done:
            done[id(x)] = fit(x, width)
        return done[id(x)]

    return (width, *([(once(t, fit_points), once(s, pad_scalars))
                      for t, s in pairs] for pairs in batches))


def _launch(pairs: Sequence, width: int, group: str, c):
    """One batch of MSMs, a table that several share taken once;
    -> its resolve()."""
    util.annotate(msms=len(pairs), n=width)
    tables = {id(t): t for t, _s in pairs}
    ids = list(tables)
    return msm_mod.msm_many_staged_deferred(
        tuple(tables.values()), [s for _t, s in pairs],
        pmap=tuple(ids.index(id(t)) for t, _s in pairs), group=group, c=c)


# ---------------------------------------------------------------------------
# Keygen
# ---------------------------------------------------------------------------

def eval_at(fc, x: int, device) -> tuple:
    """Every variable's v, w and y polynomial at x, (8, V) Montgomery
    each: the Lagrange values at x, then three transpose matvecs."""
    with util.stage("zk.keygen.lagrange"):
        lag = te._lagrange_at(fc.logn, x, device)
    nv = len(fc.vars_sorted)
    with util.stage("zk.keygen.matvec", nnz=fc.nnz):
        return tuple(te.transpose_matvec(side, lag, nv) for side in fc.sides)


def powers(x: int, n: int) -> List[int]:
    """x^0 .. x^(n-1) mod r, on the host."""
    with util.stage("zk.keygen.tau_powers", host=True, n=n):
        out, acc = [], 1
        for _ in range(n):
            out.append(acc)
            acc = acc * x % params.R
        return out


def fixed_base(group: str, batch: str, parts: Sequence, c: int,
               device) -> List[C.Point]:
    """[g * s for s in part] for each part, a list of integers or (8, m)
    Montgomery scalars, padded to a power of two of at least 16, with
    fixed-base window c -> Jacobian batches, under one span."""
    with util.stage("zk.keygen.fixed_base", group=group, batch=batch):
        out = []
        for part in parts:
            if isinstance(part, torch.Tensor):
                n = msm_mod.padded_width(part.shape[1], msm_mod.FB_MIN_LOG)
                S = F.from_mont(pad_scalars(part, n), FR)
            else:
                n = msm_mod.padded_width(len(part), msm_mod.FB_MIN_LOG)
                S = F.pack(list(part) + [0] * (n - len(part)), FR, device)
            out.append(msm_mod.fixed_base_mul(S, group=group, c=c))
        return out


def to_affine(group: str, parts: Sequence[C.Point]) -> list:
    """Jacobian batches of one group -> their affine batches, with one
    batched inversion (`ops.curve.to_affine`) over all of them."""
    with util.stage("zk.keygen.to_affine", group=group):
        if len(parts) == 1:
            return [C.to_affine(parts[0])]
        aff = C.to_affine(tuple(torch.cat([p[i] for p in parts], dim=-1)
                                for i in range(3)))
        offs = np.cumsum([0] + [p[0].shape[-1] for p in parts])
        return [tuple(x[..., offs[k]:offs[k + 1]].contiguous() for x in aff)
                for k in range(len(parts))]
