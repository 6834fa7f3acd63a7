#!/usr/bin/env python3
"""Readings that set the frame cells' limits, at the cell's own size:
for each seed, the cell's frames are judged against the plain reference
(``reference/frame_check.py``) twice: as the program's service publishes
them (the lower readings), and as the control computes them: the
reference route in the program's place with the depth rounded to
bfloat16 and the CNN in bfloat16 (the upper readings). ``--faults
leaf,pixel`` also judges the reference's own answer altered where it
is produced (the leaf swapped for its best other candidate; the pixel
moved one column).

    python3 benchmark/controls/frame_control.py \\
        --workload frame.union.mixed --seeds 11,12,13 [--program-only]

Prints one JSON line a seed, then one with the worst of each reading;
runs on the card (``--device cpu`` with ``--overrides`` for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.core import spec  # noqa: E402
from benchmark.core.main import configure_torch  # noqa: E402
from benchmark.loops import serve  # noqa: E402
from benchmark.models import grasp_service as grasp  # noqa: E402
from benchmark.reference import frame_check  # noqa: E402


def _as_published(res) -> dict:
    return {"found": bool(res.found), "degenerate": bool(res.degenerate),
            "leaf_id": int(res.leaf_id),
            "grasp_uv": np.asarray(res.grasp_uv).astype(np.int64),
            "grasp_xyz": np.asarray(res.grasp_xyz, np.float64),
            "pre_grasp_xyz": np.asarray(res.pre_grasp_xyz, np.float64)}


def altered(ref, what: str) -> dict:
    """The reference's own answer altered where it is produced: the
    leaf replaced by its best other candidate leaf, or the grasp pixel
    moved one column."""
    pub = _as_published(ref)
    if what == "leaf":
        w = np.asarray(ref.leaf_selection.weighted, np.float64)
        cand = np.asarray(ref.leaf_selection.candidate).copy()
        if pub["leaf_id"] > 0:
            cand[pub["leaf_id"] - 1] = False
        if cand.any():
            pub["leaf_id"] = int(np.argmax(np.where(cand, w, -np.inf))) + 1
    else:
        pub["grasp_uv"] = pub["grasp_uv"] + np.array([1, 0])
    return pub


def readings(cell, seed: int, dev, overrides=None, program=True,
             control=True, faults=()) -> dict:
    """{"program": worst readings, "control": worst readings} over the
    cell's ``check_frames`` frames of ``seed``'s cycle."""
    from leafgrasp_tpu_torch import config as pconfig
    from benchmark.reference.grasp_ref import config as rconfig
    overrides = overrides or {}
    traffic = dict(cell.traffic, **overrides)
    cfg = grasp.pipeline_config(cell.config, pconfig, overrides)
    ref_cfg = grasp.pipeline_config(cell.config, rconfig, overrides)
    state = grasp.cnn_state(cfg, seed, dev)
    frames = serve.frame_cycle(traffic, seed, cfg.frame.height,
                               cfg.frame.width, dev, False)
    rng = np.random.default_rng([seed, 3])
    k = min(int(traffic["check_frames"]), len(frames))
    picks = sorted(rng.choice(len(frames), k, replace=False))
    ref_cnn = grasp.reference_cnn(ref_cfg, state, dev)
    refs = [frame_check.reference_frame(frames[j][0], frames[j][1],
                                        cfg.camera, ref_cnn, ref_cfg, dev)
            for j in picks]
    out = {}
    if program:
        cnn = grasp.program_cnn(cfg, state, dev)
        service = serve.build_service(cfg, cnn, None, dev, cell.config)
        got = []
        for j, ref in zip(picks, refs):
            service.on_mask(frames[j][0], j + 1)
            service.on_depth(frames[j][1], j + 1)
            pub = frame_check.published(service.process_pending(force=True))
            got.append(frame_check.judge(ref, pub))
        service.bus.close()
        out["program"] = frame_check.worst(got)
    if control:
        ctl_cnn = frame_check.Bf16Cnn(
            grasp.reference_cnn(ref_cfg, state, dev))
        got = []
        for j, ref in zip(picks, refs):
            depth = torch.as_tensor(frames[j][1]).to(torch.bfloat16) \
                .to(torch.float32).numpy()
            ctl = frame_check.reference_frame(frames[j][0], depth,
                                              cfg.camera, ctl_cnn, ref_cfg,
                                              dev)
            got.append(frame_check.judge(ref, _as_published(ctl)))
        out["control"] = frame_check.worst(got)
    for what in faults:
        out["fault_" + what] = frame_check.worst(
            frame_check.judge(ref, altered(ref, what)) for ref in refs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="frame.union.mixed")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--control-only", action="store_true")
    ap.add_argument("--faults", default="",
                    help="comma-separated: leaf, pixel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    configure_torch(torch)
    cell = spec.resolve(args.workload)
    worst: dict = {}
    for s in args.seeds.split(","):
        r = readings(cell, int(s), dev, json.loads(args.overrides),
                     program=not args.control_only,
                     control=not args.program_only,
                     faults=[f for f in args.faults.split(",") if f])
        print(json.dumps({"seed": int(s), **r}), flush=True)
        for side, agg in r.items():
            w = worst.setdefault(side, {})
            for key, val in agg.items():
                if key in ("frames", "same_pixel") or side.startswith(
                        "fault") or side == "control":
                    w[key] = min(w.get(key, val), val)
                else:
                    w[key] = max(w.get(key, val), val)
    print(json.dumps({"worst": worst}), flush=True)
    return worst


if __name__ == "__main__":
    main()
