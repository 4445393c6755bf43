"""Start a local group of ranks, one process each, and collect their
results.

A distributed run on GPUs is one process per GPU started by ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous),
each calling ``torch.distributed.init_process_group("nccl")`` before it
builds a ``DistSimulation`` or ``ParticleDistSimulation``.  This module
covers the other two ways in:

* ``run_ranks`` spawns ``world`` processes on this host (the ``spawn``
  start method, never ``fork``: the caller may hold threads), joins them
  in a ``file://`` rendezvous under a fresh temporary directory (no port to
  collide with another run), calls ``fn(rank, world, *args)`` in each and
  returns the results in rank order.  Each child pins one PyTorch thread.
  A failed rank fails the call with its traceback, the others killed; a
  run past ``timeout`` seconds is killed and raises ``TimeoutError``.
  ``fn`` must be importable by name, and a child imports only PyTorch and
  this package.
* ``init_single_rank`` makes the calling process a group of one (an
  in-process ``HashStore``, no network), for one device.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run_ranks", "init_single_rank"]


def _child(rank, world, init_file, backend, timeout, fn, args, out_path):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            payload = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent reports the traceback and fails
        payload = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out_path + ".tmp", out_path)
    if payload[0] != "ok":
        raise SystemExit(1)


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_ranks(world: int, fn, args=(), backend: str = "gloo",
              timeout: float = 120.0):
    """``[fn(r, world, *args) for r in range(world)]``, each in a process of
    its own within one process group of ``world`` ranks."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="warpx_ranks_")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(
        target=_child, daemon=True,
        args=(r, world, os.path.join(tmp, "rendezvous"), backend, timeout,
              fn, tuple(args), outs[r])) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                r = failed[0]
                why = (_read(outs[r])[1] if os.path.exists(outs[r])
                       else f"exit code {procs[r].exitcode}")
                raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
            time.sleep(0.02)
        results = []
        for r, p in enumerate(procs):
            if p.exitcode != 0 or not os.path.exists(outs[r]):
                why = (_read(outs[r])[1] if os.path.exists(outs[r])
                       else f"exit code {p.exitcode}")
                raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
            results.append(_read(outs[r])[1])
        return results
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def init_single_rank(backend: str, timeout: float = 120.0) -> None:
    """Make this process a process group of one rank, rendezvous in
    memory (``"cpu:gloo,cuda:nccl"`` where one process needs both)."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=timeout))
