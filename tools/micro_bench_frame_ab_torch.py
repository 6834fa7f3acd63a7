#!/usr/bin/env python3
"""Interleaved A/B of the port's full frame under two
``GraspScoringConfig`` variants: the counterpart of
tools/micro_bench_frame_ab.py, under its definitions.

Variant ``old`` is the pre-r5 knobs (envelope stride 8 / k 2048, the
per-offset ``"runs"`` interference pass 1); ``new`` is the defaults
(stride 16 / k 1024, the sparse-table ``"levels"`` pass 1). Both run in
``reference_self`` and ``union`` with the CNN, over bench.py's three
families (``--per-family`` rolled frames each, staged on the device
before any clock starts), interleaved A/B/A/B in one process. Every
frame's grasp pixel must be identical between the variants: the knobs
preserve the answer by construction (coverage-guarded envelope,
reassociated integer mins), so a difference raises.

Times: ms a frame of one pass over all frames, CUDA events around the
pass (``torch.cuda.synchronize()`` as the barrier), best of ``--reps``.
Beside each variant, the launches of each kernel and the blocking host
reads a frame, from the first pass.

Prints the JAX tool's lines, then one JSON line with the same numbers
and ``device`` (the card's name and power limit).

    python tools/micro_bench_frame_ab_torch.py [--reps 3] [--per-family 8]
    python tools/micro_bench_frame_ab_torch.py --device cpu   # slow
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_bench import Counts, device_stamp, event_ms  # noqa: E402
from tools._torch_eval import (CAMERA, add_device_arg,  # noqa: E402
                               setup_device)

OLD_KNOBS = dict(envelope_stride=8, envelope_k=2048, dvd_impl="runs")
MODES = ("reference_self", "union")


def variant_configs(base):
    """{"<mode>:old" / "<mode>:new": config} on ``base``."""
    out = {}
    for mode in MODES:
        out[f"{mode}:old"] = base.replace(grasp=dataclasses.replace(
            base.grasp, isolation_context=mode, **OLD_KNOBS))
        out[f"{mode}:new"] = base.replace(grasp=dataclasses.replace(
            base.grasp, isolation_context=mode))
    return out


def measure(base, frames, cnn, dev, reps: int, camera=CAMERA):
    """(best ms a frame, {variant: (launches, host reads) a frame},
    {variant: [[u, v] of each frame]}) over the staged ``frames``
    ((family, mask, depth) on ``dev``); raises if a frame's pixel
    differs between the variants of a mode."""
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    cx, cy, f = (np.float32(v) for v in camera)
    fns = {key: make_frame_fn(cfg, with_cnn=True, device=dev)
           for key, cfg in variant_configs(base).items()}
    n = len(frames)

    def run(fn):
        return [fn(m, d, cx, cy, f, cnn) for _, m, d in frames]

    uv, counts = {}, {}
    for key, fn in fns.items():         # warm-up, counts, pixels
        c = Counts()
        results = run(fn)
        launches, reads = c.read()
        counts[key] = ({k: v / n for k, v in launches.items()}, reads / n)
        uv[key] = [[int(x) for x in p] for p in
                   fetch_to_host([r.grasp_uv for r in results])]
    for mode in MODES:
        for i, (a, b) in enumerate(zip(uv[f"{mode}:old"],
                                       uv[f"{mode}:new"])):
            if a != b:
                raise RuntimeError(f"{mode} frame {i}: grasp pixel {a} "
                                   f"with the old knobs, {b} with the new")
    best = {key: float("inf") for key in fns}
    for _ in range(reps):
        for key, fn in fns.items():     # interleaved A/B
            best[key] = min(best[key],
                            event_ms(lambda: run(fn), dev) / n)
    return best, counts, uv


def main(argv=None):
    """Run the A/B and print its lines and record; returns the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--per-family", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    import bench_torch
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    frames = bench_torch.stage_frames(DEFAULT_CONFIG, args.per_family, dev)
    cnn, _ = init_grasp_cnn(0, DEFAULT_CONFIG.model)
    cnn = cnn.to(dev).eval()
    best, counts, _ = measure(DEFAULT_CONFIG, frames, cnn, dev, args.reps)
    print(f"grasp pixels identical old vs new: {len(frames)} frames x 2 "
          f"modes", flush=True)
    for key, ms in best.items():
        launches, reads = counts[key]
        print(f"{key:22s} {ms:7.2f} ms/frame  ({sum(launches.values()):.0f} "
              f"launches of the port's kernels, {reads:.1f} host reads a "
              f"frame)")
    speedup = {}
    for mode in MODES:
        o, n = best[f"{mode}:old"], best[f"{mode}:new"]
        speedup[mode] = o / n
        print(f"{mode}: old {o:.2f} -> new {n:.2f} ms/frame ({o / n:.3f}x)")
    rec = {"tool": "micro_bench_frame_ab", "frames": len(frames),
           "reps": args.reps, "identical_pixels": True,
           "ms_per_frame": best, "speedup_old_over_new": speedup,
           "launches_per_frame": {k: c[0] for k, c in counts.items()},
           "host_reads_per_frame": {k: c[1] for k, c in counts.items()},
           "device": device_stamp(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
