"""The port's N-rank spawner for tests and on-card runs, the counterpart of
``repro/testing.py::run_mesh_subprocess``.

:func:`run_ranks` starts ``nprocs`` processes (``torch.multiprocessing``,
the spawn start method), joins them in one process group (gloo on CPU
tensors, or NCCL with card ``rank`` for each rank) through a file store in
a temporary directory, runs ``fn(rank, world, *args)`` in each and returns
each rank's result, which must pickle. ``fn`` must be importable by name
(a module-level function), as spawn requires.

One deadline bounds the whole run and is also the group's collective
timeout, so a rank that never reaches a collective ends the others. A
rank that raises, dies or misses the deadline ends the run: the others
are killed and a ``RuntimeError`` carries the failing rank's traceback
tail.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback


def _rank_main(fn, rank, world, store, backend, timeout, results, args):
    import torch
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, *args, backend: str = "gloo", timeout: float = 240) -> list:
    """``[fn(rank, nprocs, *args) for each rank]``, each in its own process
    of one ``nprocs``-rank group (see the module docstring)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failed = {}, None
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, os.path.join(tmp, "store"), backend,
                                   timeout, results, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < nprocs and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed = (None, f"the {nprocs} ranks did not finish in {timeout} s")
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        failed = (dead[0], f"exit code {procs[dead[0]].exitcode}, no result")
                    continue
                if ok:
                    got[rank] = payload
                else:
                    failed = (rank, payload)
        finally:
            for p in procs:
                p.join(timeout=5 if failed is None else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        rank, tail = failed
        who = "the run" if rank is None else f"rank {rank} of {nprocs}"
        raise RuntimeError(f"{who} failed:\n{tail[-3000:]}")
    return [got[r] for r in range(nprocs)]
