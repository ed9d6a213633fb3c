"""A world of ranks on one host, one process each, with a deadline.

For the tests (gloo worlds on the CPU) and the smoke run on the card (gloo
worlds whose ranks share one card): ``run_world(fn, n)`` spawns ``n``
processes, each of which joins a process group through a rendezvous file
(no port, so many worlds can run at once), calls ``fn(rank, n, *args)`` and
hands back what it returns. A world that outlives its deadline is killed
and raises, so a hung collective fails its caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, nprocs, workdir, timeout, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}", world_size=nprocs, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(fn, nprocs: int, args: tuple = (), timeout: float = 120.0, workdir: str | None = None) -> list:
    """``[fn(rank, nprocs, *args) for each rank]``, run in ``nprocs`` spawned
    processes that form one gloo world. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function of an importable module), as must what
    ``fn`` returns. Raises if a rank raises or exits, and kills the world
    and raises ``TimeoutError`` after ``timeout`` seconds (which also bounds
    every collective in it). The rendezvous file and the ranks' results go
    to ``workdir``, or to a temporary directory removed after."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="world-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    try:
        ctx = mp.start_processes(_entry, args=(fn, nprocs, workdir, timeout, args), nprocs=nprocs,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {nprocs} ranks ran past its {timeout:.0f} s deadline")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = []
        for rank in range(nprocs):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
