"""Spawned ``gloo`` CPU ranks for the port's parallel tests.

Imports no JAX: each rank runs only the port. The JAX side of a test
runs in the pytest process. Each spawn costs a few seconds of process
start-up, so a test groups several checks in one rank function. Rank
functions live in modules that import no JAX at the top (the spawned
ranks import them by name)."""

from leafgrasp_tpu_torch.parallel.launch import run_ranks

__all__ = ["spawn"]

RANK_TIMEOUT_S = 60.0
JOIN_S = 90.0


def spawn(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo CPU ranks, one torch
    thread each, the store under ``tmp_path`` (so pytest-xdist workers
    never share one); returns the results in rank order."""
    return run_ranks(fn, world, str(tmp_path / f"store_{fn.__name__}"),
                     *args, timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
