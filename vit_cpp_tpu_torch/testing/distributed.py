"""Run a function on N gloo CPU ranks: the multi-device tests' harness.

`run_ranks(fn, world, *args, timeout=...)` spawns `world` processes; each
sets one intra-op thread, joins a gloo group through a FileStore in a
fresh temporary directory (never a fixed port: several test workers run
at once) with a collective timeout, calls `fn(*args)` and reports back.
It returns rank 0's result. If a rank raises or exits, or the ranks run
past `timeout` seconds, every rank is killed and RuntimeError is raised
with the failing rank's traceback, so a hang fails one test instead of
the suite. `fn` and its arguments must pickle (a module-level function).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(fn, rank: int, world: int, store_path: str, timeout: float, results, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=timedelta(seconds=timeout),
        )
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0):
    """fn(*args) on `world` gloo CPU ranks -> rank 0's return value."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vit_ranks_")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main,
                    args=(fn, r, world, os.path.join(tmp, "store"), timeout, results, args),
                    daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    done, out, failure = set(), None, None
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    failure = f"ranks did not finish within {timeout:g} s"
                gone = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if gone and failure is None:
                    try:  # a report sent just before the exit
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = (f"rank {gone[0]} exited with code "
                                   f"{procs[gone[0]].exitcode} without reporting")
                        continue
                else:
                    continue
            if not ok:
                failure = f"rank {rank} raised:\n{value}"
            done.add(rank)
            if rank == 0:
                out = value
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=30.0 if failure is None else 5.0)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return out
