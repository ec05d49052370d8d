"""Worlds of ranks for `parallel.sharded`: the process plumbing that a JAX
mesh, which lives in one process, does not need.

  * `spawn(target, world, device, *args)` starts `world` ranks with
    torch.multiprocessing (the spawn method).  They meet through a fresh
    `file://` store in a temporary directory (no TCP port, so concurrent
    test workers cannot collide), on gloo when `device` is "cpu" (each
    rank at one thread) and on NCCL otherwise (rank r on cuda:r).  Each
    rank calls `target(mesh, *args)`, where `target` is the dotted name of
    a function of this package and `mesh` the whole world's
    `sharded.make_mesh`; it returns a dict of numpy arrays (or None),
    which comes back as one `.npy` file a key.  `spawn` returns every
    rank's dict, in rank order.  A rank that raises makes `spawn` raise
    (with its traceback), after the other ranks are stopped.
  * `init_world1(device)`: a world of one rank in this process, as a
    context manager yielding its mesh (the CLIs and `chip_smoke.py`).

On a machine with several cards, `torchrun --nproc-per-node N script.py`
starts the ranks instead: the script calls
`torch.distributed.init_process_group("nccl")` and `sharded.make_mesh()`.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import sharded

PACKAGE = "zukelang_tpu_torch."
# how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)


def _backend(device) -> str:
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def _resolve(target: str):
    if not target.startswith(PACKAGE):
        raise ValueError(f"spawn: {target!r} is not a function of "
                         f"{PACKAGE.rstrip('.')}")
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def _init(rank: int, world: int, device, store: str) -> None:
    if _backend(device) == "gloo":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(_backend(device), init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=TIMEOUT)


def _rank_main(rank: int, world: int, device, tmp: str, target: str,
               args: tuple) -> None:
    out = os.path.join(tmp, f"rank{rank}")
    try:
        _init(rank, world, device, os.path.join(tmp, "store"))
        try:
            res = _resolve(target)(sharded.make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        os.makedirs(out)
        for key, val in (res or {}).items():
            np.save(os.path.join(out, f"{key}.npy"), np.asarray(val),
                    allow_pickle=False)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _read(path: str) -> dict:
    return {f[:-4]: np.load(os.path.join(path, f), allow_pickle=False)
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def spawn(target: str, world: int, device, *args,
          timeout: float = 3600) -> list:
    """Run `target(mesh, *args)` on `world` new ranks (see the module
    note) -> [rank 0's result dict, ...]."""
    if _backend(device) == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"spawn: {world} NCCL ranks need as many CUDA "
                           f"devices, found {torch.cuda.device_count()}")
    _resolve(target)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="zk-world-")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device, tmp, target, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            for p in procs:
                p.join(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errs = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                path = os.path.join(tmp, f"rank{r}.err")
                why = (open(path).read() if os.path.exists(path) else
                       f"exit code {p.exitcode}")
                errs.append(f"rank {r} of {world}: {why}")
        if errs:
            raise RuntimeError(f"spawn {target}: " + "\n".join(errs))
        return [_read(os.path.join(tmp, f"rank{r}")) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def init_world1(device=None):
    """A world of one rank in this process (gloo for "cpu", else NCCL on
    cuda:0); yields its mesh and destroys the group on exit."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_world1: needs a CUDA device (pass "
                           "device='cpu' for gloo on the CPU)")
    tmp = tempfile.mkdtemp(prefix="zk-world-")
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(_backend(device),
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=TIMEOUT)
        try:
            yield sharded.make_mesh(device=dev.type)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
