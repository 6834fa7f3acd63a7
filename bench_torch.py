#!/usr/bin/env python3
"""End-to-end grasp-selection benchmark of the PyTorch port on one GPU:
the counterpart of bench.py, under its definitions.

Prints ONE JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, ...}
plus ``device``: the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.

Methodology, as bench.py's:
* N distinct frames (the three scene families, ``np.roll`` offsets) are
  staged on the device before any clock starts; each pass dispatches all
  of them. The barrier before the clock stops is
  ``torch.cuda.synchronize()``, which waits for every queued kernel.
* Three scene families (sparse / crowded / large-leaf); the headline
  ``value`` is the mixed-family throughput, ``worst_case_fps`` the
  slowest family; best of two passes each.
* Two configurations: ``reference_self`` isolation (the headline) and
  DEFAULT_CONFIG's ``union`` (``enhanced_isolation_mode_fps``).
* The standard GraspPointCNN with seeded weights (the port's
  ``init_grasp_cnn(seed=0)``).
* vs_baseline = fps / 50 (BASELINE.json's north star).
* ``vla_service_fps`` is read back from the port's own service record
  ``artifacts/torch/vla_service_bench.json`` (written by
  tools/bench_vla_service_torch.py), with its provenance and a warning
  on stderr when it was measured at another commit than HEAD.

    python bench_torch.py                 # on the card
    python bench_torch.py --device cpu    # the CPU path (slow at full size)

LEAFGRASP_BENCH_PER_FAMILY (default 28) sets the frames a family.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from tools._torch_bench import TORCH_ARTIFACTS, device_stamp, git_rev, sync
from tools._torch_eval import ROOT, add_device_arg, setup_device

# (name, num_leaves, seed, margin): bench.py:37-41
FAMILIES = [
    ("sparse", 6, 8, 120),
    ("crowded", 12, 3, 60),
    ("large_leaf", 3, 5, 260),
]
CAMERA = (707.87, 494.07, 1750.68)
BASELINE_FPS = 50.0
PASSES = 2
VLA_ARTIFACT = os.path.join(TORCH_ARTIFACTS, "vla_service_bench.json")


def bench_configs(base=None):
    """(reference_self config, enhanced config): bench.py:56-62 on
    ``base`` (DEFAULT_CONFIG)."""
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    base = DEFAULT_CONFIG if base is None else base
    ref = base.replace(grasp=dataclasses.replace(
        base.grasp, isolation_context="reference_self"))
    return ref, base


def stage_frames(cfg, per_family: int, dev, families=FAMILIES):
    """[(family, mask, depth)] on ``dev``: ``per_family`` rolled copies
    of each family's scene, staged before any clock starts."""
    import torch
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    frames = []
    for name, n_leaves, seed, margin in families:
        mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                      num_leaves=n_leaves, seed=seed,
                                      margin=margin)
        for i in range(per_family):
            frames.append((name,
                           torch.as_tensor(np.roll(mask, 3 * i, axis=1))
                           .to(dev),
                           torch.as_tensor(np.roll(depth, 3 * i, axis=1))
                           .to(dev)))
    sync(dev)
    return frames


def answers_of(frames, results):
    """Each frame's (family, leaf, [u, v], found, degenerate)."""
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    out = []
    for (name, _, _), res in zip(frames, results):
        leaf, uv, found, deg = fetch_to_host(
            (res.leaf_id, res.grasp_uv, res.found, res.degenerate))
        out.append((name, int(leaf), [int(v) for v in uv], bool(found),
                    bool(deg)))
    return out


def measure(config, frames, cnn, dev, camera=CAMERA):
    """(mixed fps, {family: fps}, answers of the mixed pass's frames) of
    ``config`` over the staged ``frames``: best of PASSES passes each."""
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    fn = make_frame_fn(config, with_cnn=True, device=dev)
    cx, cy, f = (np.float32(v) for v in camera)
    fn(frames[0][1], frames[0][2], cx, cy, f, cnn)       # warm-up
    sync(dev)

    def run(subset):
        best, results = float("inf"), None
        for _ in range(PASSES):
            t0 = time.perf_counter()
            results = [fn(m, d, cx, cy, f, cnn) for (_, m, d) in subset]
            sync(dev)
            best = min(best, time.perf_counter() - t0)
            assert tuple(results[-1].grasp_uv.shape) == (2,)
        return len(subset) / best, results

    mixed, results = run(frames)
    fam = {name: run([fr for fr in frames if fr[0] == name])[0]
           for name in dict.fromkeys(fr[0] for fr in frames)}
    return mixed, fam, answers_of(frames, results)


def vla_service_fields(path: str = VLA_ARTIFACT) -> dict:
    """``vla_service_fps`` and its provenance from the port's service
    record (bench.py:129-160), or {} when there is none."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        v = json.load(f)
    head = git_rev()
    art_rev = v.get("git_rev")
    if head and art_rev and head != art_rev:
        print(f"WARNING: {os.path.relpath(path, ROOT)} was measured at "
              f"{art_rev} but HEAD is {head}; the replayed "
              f"vla_service_fps may be stale -- re-run "
              f"tools/bench_vla_service_torch.py", file=sys.stderr)
    return {"vla_service_fps": v["value"],
            "vla_service_provenance": {
                "tool": "tools/bench_vla_service_torch.py",
                "quantize": v.get("quantize"), "dims": v.get("dims"),
                "backend": v.get("backend"),
                "recorded_unix": v.get("recorded_unix"),
                "git_rev": art_rev, "head_rev": head,
                "serial_fps": v["value"],
                "overlap_fps": v.get("overlap_fps")}}


def main(argv=None, answers=None):
    """Run the benchmark and print its record; returns it. ``answers``,
    a dict, receives each configuration's per-frame answers (the mixed
    pass's frames, ``answers_of``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    cfg, cfg_enh = bench_configs()
    per_family = int(os.environ.get("LEAFGRASP_BENCH_PER_FAMILY", "28"))
    frames = stage_frames(cfg, per_family, dev, FAMILIES)
    cnn, _ = init_grasp_cnn(0, cfg.model)
    cnn = cnn.to(dev).eval()

    fps, fam, ans = measure(cfg, frames, cnn, dev, CAMERA)
    fps_enh, fam_enh, ans_enh = measure(cfg_enh, frames, cnn, dev, CAMERA)
    worst = min(fam.values())
    rec = {
        "metric": "end_to_end_grasp_selection_frames_per_sec_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "enhanced_isolation_mode_fps": round(fps_enh, 3),
        "worst_case_fps": round(worst, 3),
        "family_fps": {k: round(v, 3) for k, v in fam.items()},
        "family_fps_enhanced": {k: round(v, 3) for k, v in fam_enh.items()},
    }
    rec.update(vla_service_fields(VLA_ARTIFACT))
    rec["device"] = device_stamp(dev)
    print(json.dumps(rec), flush=True)
    if answers is not None:
        answers.update({"reference_self": ans, "union": ans_enh})
    return rec


if __name__ == "__main__":
    main()
