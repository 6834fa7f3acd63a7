"""Probe the collectives the port's parallel layer uses on CUDA tensors:
for each backend and world size, whether ``all_reduce`` (SUM, MAX, MIN),
the list form of ``all_gather`` and ``broadcast`` take float32, float64,
bfloat16, int32, int64 and int8 tensors on ``cuda:0`` and give the right
values (a collective the backend refuses counts as failed, its error
kept), whether a ("data", "model") ``DeviceMesh`` builds over the group,
and the time of a 4-byte ``all_reduce`` (mean of 200), of a 1 MB
``all_gather`` (mean of 20) and of a 20 MB bfloat16 ``all_gather`` and
``all_reduce`` (mean of 5: one pipeline hand-off of a 2400-token row at
4096 wide), host clock after a synchronize.

    python tools/probe_collectives_torch.py

It runs gloo at 2 and 4 ranks (sharing the card) and nccl at 1, each
rank a process (``parallel/launch.run_ranks``, a file store under
``build/``), and prints one JSON object; it exits non-zero when a
collective failed or gave a wrong value, or without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = (("gloo", 2), ("gloo", 4), ("nccl", 1))
DTYPES = ("float32", "float64", "bfloat16", "int32", "int64", "int8")


def _rank(rank, world):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    ok, times, errors = {}, {}, {}

    def check(key, run):
        # a refusal raises on every rank alike, so the group stays in step
        try:
            ok[key] = run()
        except (RuntimeError, ValueError, TypeError) as exc:
            ok[key] = False
            errors[key] = str(exc).splitlines()[0][:200]

    want = {"SUM": world * (world + 1) // 2, "MAX": world, "MIN": 1}
    for name in DTYPES:
        dt = getattr(torch, name)
        for op, value in want.items():
            def reduce(op=op, value=value):
                t = torch.full((5,), rank + 1, dtype=dt, device=dev)
                dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
                return t.tolist() == [value] * 5
            check(f"all_reduce_{op}_{name}", reduce)

        def gather():
            t = torch.full((3,), rank, dtype=dt, device=dev)
            outs = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(outs, t)
            return [o.tolist()[0] for o in outs] == list(range(world))
        check(f"all_gather_{name}", gather)

        def broadcast():
            t = torch.full((3,), rank + 7, dtype=dt, device=dev)
            dist.broadcast(t, 0)
            return t.tolist() == [7] * 3
        check(f"broadcast_{name}", broadcast)
    model = 2 if world % 2 == 0 and world > 2 else 1
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(-1, model),
                      mesh_dim_names=("data", "model"))
    t = torch.ones(2, device=dev)
    dist.all_reduce(t, group=mesh.get_group("data"))
    ok["mesh_data_sum"] = t.tolist() == [world // model] * 2
    t = torch.ones(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    times["all_reduce_4B_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    big = torch.ones(1 << 18, device=dev)
    outs = [torch.empty_like(big) for _ in range(world)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_gather(outs, big)
    torch.cuda.synchronize()
    times["all_gather_1MB_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    hand = torch.ones((2400, 4096), dtype=torch.bfloat16, device=dev)
    outs = [torch.empty_like(hand) for _ in range(world)]
    for name, run in (("all_gather", lambda: dist.all_gather(outs, hand)),
                      ("all_reduce", lambda: dist.all_reduce(hand))):
        def timed(run=run):
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            times[f"{name}_20MB_bf16_ms"] = \
                (time.perf_counter() - t0) / 5 * 1e3
            return True
        check(f"{name}_20MB_bf16", timed)
    return ok, times, errors


def main() -> int:
    import torch
    from leafgrasp_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    os.makedirs("build", exist_ok=True)
    out, good = {}, True
    for backend, world in RUNS:
        res = run_ranks(_rank, world, os.path.join(
            "build", f"probe_store_{backend}_{world}"), backend=backend,
            timeout_s=60.0, join_s=240.0, threads=0)
        failed = sorted({k for ok, _, _ in res for k, v in ok.items()
                         if not v})
        good = good and not failed
        out[f"{backend}{world}"] = {"failed": failed, "rank0": res[0][1],
                                    "errors": res[0][2]}
    print(json.dumps(out))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
