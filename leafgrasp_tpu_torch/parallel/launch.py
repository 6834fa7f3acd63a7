"""Spawn the ranks of one SPMD program on this host.

``run_ranks(fn, world, store_path, *args)`` starts ``world`` processes
(the ``spawn`` method), joins them into one process group through a
``FileStore`` at ``store_path`` (no port to race for), calls
``fn(rank, world, *args)`` in each and returns the ranks' results in
rank order. The group has a timeout, so a rank stuck in a collective
its peers never issue raises instead of hanging, and the parent gives
up on the ranks after ``join_s`` seconds; either way, and on any rank's
exception (its traceback is re-raised here), every process is stopped
before this returns. ``fn`` must be importable by name (a module-level
function) and its arguments and result picklable (tensors in a result
come back as copies).
"""

from __future__ import annotations

import os
import pickle
import queue
import time
import traceback
from datetime import timedelta

__all__ = ["run_ranks"]


def _rank_main(fn, rank, world, store_path, backend, timeout_s, threads,
               results, args):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        # plain pickle bytes: the queue's own pickler would share a
        # tensor's storage through a descriptor that dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:                  # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, store_path: str, *args,
              backend: str = "gloo", timeout_s: float = 60.0,
              join_s: float = 120.0, threads: int = 1) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own process of one ``backend`` group (see the module
    docstring). ``threads`` sets each rank's torch threads (0 leaves
    torch's default)."""
    import multiprocessing as mp

    if os.path.exists(store_path):
        os.remove(store_path)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, backend, timeout_s,
                               threads, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors, reported = {}, [], set()
    deadline = time.monotonic() + join_s
    dead_since = {}
    try:
        # drain the queue before joining: a rank blocks in put() until
        # its result is read
        while len(reported) < world:
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(f"{world - len(reported)} of {world} "
                                   f"ranks gave no result in {join_s} s")
            try:
                rank, ok, out = results.get(timeout=min(deadline - now,
                                                        1.0))
            except queue.Empty:
                # a rank that died without reporting (a crash): give its
                # last words a moment to arrive, then stop waiting
                for r, p in enumerate(procs):
                    if r not in reported and p.exitcode not in (None, 0):
                        if now - dead_since.setdefault(r, now) > 5.0:
                            raise RuntimeError(
                                f"rank {r} exited with {p.exitcode} "
                                f"without a result") from None
                continue
            reported.add(rank)
            if ok:
                got[rank] = pickle.loads(out)
            else:
                errors.append(f"rank {rank}:\n{out}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if os.path.exists(store_path):
            os.remove(store_path)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world)]
