#!/usr/bin/env python3
"""Single-card throughput A/B: single frames back to back against the
batched frame function: the counterpart of tools/micro_bench_batch.py,
under its definitions.

16 ``sparse`` frames at 1080 x 1440 (6 leaves, seed 8, each rolled by
3 px), ``reference_self`` with the seeded standard CNN, staged on the
device. ``single`` dispatches 16 frames through ``make_frame_fn`` back
to back; ``batch<B>`` calls ``make_batched_frame_fn``
(parallel/batch.py) on the first B frames, 16 / B times, on a one-rank
mesh (nccl on a card, gloo on the CPU; a file store in a temporary
directory), which the tool tears down at the end. Each trial times
every row between CUDA events (``torch.cuda.synchronize()`` as the
barrier), in turns; the rows report their best ms a frame and its
frames/s, and the launches and host reads a frame of one call. Every
batched frame's pixel must equal its single frame's, else the tool
raises.

The JAX tool's second axis, ``use_pallas`` (``batch4_pallas0/1``), has
no counterpart: the port dispatches each kernel by the tensor's device,
so on the card every row runs the kernels. The port's batched function
runs the single-frame path a frame at a time on its rank (its frame
path reads scalars back and sizes windows from them, so it does not
vectorize), so the rows compare the same frames with one collective
more.

Prints the JAX tool's lines, then one JSON line with the same numbers
and ``device`` (the card's name and power limit).

    python tools/micro_bench_batch_torch.py [--trials 5]
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_bench import (Counts, device_stamp, event_ms,  # noqa: E402
                                sync)
from tools._torch_eval import (CAMERA, add_device_arg,  # noqa: E402
                               setup_device)

N = 16
BATCHES = (2, 4, 8)
SCENE = dict(num_leaves=6, seed=8, margin=120)


def batch_config(base=None):
    """``base`` (DEFAULT_CONFIG) in ``reference_self``."""
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    base = DEFAULT_CONFIG if base is None else base
    return base.replace(grasp=dataclasses.replace(
        base.grasp, isolation_context="reference_self"))


def stage(cfg, n: int, dev, scene=SCENE):
    """(masks, depths): ``n`` rolled copies of ``scene`` on ``dev``."""
    import torch
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                  **scene)
    masks = [torch.as_tensor(np.roll(mask, 3 * i, axis=1)).to(dev)
             for i in range(n)]
    depths = [torch.as_tensor(np.roll(depth, 3 * i, axis=1)).to(dev)
              for i in range(n)]
    sync(dev)
    return masks, depths


@contextlib.contextmanager
def one_rank_group(dev):
    """A one-rank process group for ``dev`` (nccl on a card, gloo on the
    CPU) through a file store, destroyed on the way out."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def measure(cfg, masks, depths, cnn, dev, batches=BATCHES, trials: int = 5,
            camera=CAMERA):
    """({row: best ms a frame}, {row: (launches, host reads) a frame},
    {row: [[u, v] of each frame]}); ``single`` runs every frame, each
    ``batch<B>`` the first B. Raises if a batched pixel differs from its
    single frame's."""
    import torch
    from leafgrasp_tpu_torch.parallel import make_batched_frame_fn, make_mesh
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    cx, cy, f = (np.float32(v) for v in camera)
    n = len(masks)
    if max(batches) > n:
        raise ValueError(f"a batch of {max(batches)} from {n} frames")
    single = make_frame_fn(cfg, with_cnn=True, device=dev)
    with one_rank_group(dev):
        batched = make_batched_frame_fn(make_mesh(1, device=dev), cfg,
                                        with_cnn=True)
        stacks = {b: (torch.stack(masks[:b]), torch.stack(depths[:b]))
                  for b in batches}
        calls = {"single": lambda: [single(masks[i], depths[i], cx, cy, f,
                                           cnn) for i in range(n)]}
        for b in batches:
            calls[f"batch{b}"] = (lambda mb, db: lambda: batched(
                mb, db, cx, cy, f, cnn))(*stacks[b])
        counts, uv = {}, {}
        for name, fn in calls.items():  # warm-up, counts, pixels
            c = Counts()
            out = fn()
            launches, reads = c.read()
            frames = n if name == "single" else int(name[5:])
            counts[name] = ({k: v / frames for k, v in launches.items()},
                            reads / frames)
            uv[name] = ([[int(x) for x in p] for p in fetch_to_host(
                [r.grasp_uv for r in out])] if name == "single" else
                fetch_to_host(out.grasp_uv).tolist())
        for b in batches:
            if uv[f"batch{b}"] != uv["single"][:b]:
                raise RuntimeError(f"batch{b} pixels {uv[f'batch{b}']} != "
                                   f"the single frames' {uv['single'][:b]}")
        best = {name: float("inf") for name in calls}
        for _ in range(trials):
            best["single"] = min(best["single"],
                                 event_ms(calls["single"], dev) / n)
            for b in batches:
                reps = max(1, n // b)
                best[f"batch{b}"] = min(
                    best[f"batch{b}"],
                    event_ms(calls[f"batch{b}"], dev, reps) / b)
    return best, counts, uv


def main(argv=None):
    """Run the A/B and print its lines and record; returns the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    cfg = batch_config()
    masks, depths = stage(cfg, N, dev)
    cnn, _ = init_grasp_cnn(0, cfg.model)
    cnn = cnn.to(dev).eval()
    best, counts, _ = measure(cfg, masks, depths, cnn, dev,
                              trials=args.trials)
    for name, ms in best.items():
        print(f"{name:20s} min {ms:7.2f} ms/frame  ({1000 / ms:6.1f} fps)",
              flush=True)
    rec = {"tool": "micro_bench_batch", "frames": N, "trials": args.trials,
           "batched_equal_single": True, "ms_per_frame": best,
           "fps": {k: 1000 / v for k, v in best.items()},
           "launches_per_frame": {k: c[0] for k, c in counts.items()},
           "host_reads_per_frame": {k: c[1] for k, c in counts.items()},
           "device": device_stamp(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
