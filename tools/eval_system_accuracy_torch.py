#!/usr/bin/env python3
"""Classical-vs-hybrid system comparison on synthetic scenes, on the
PyTorch port: the counterpart of tools/eval_system_accuracy.py.

For each scene (seed 100 + i, 4/6/8 leaves in turn) the classical frame
(CV only) and the hybrid frame (CV + the GraspPointCNN's fusion) pick a
leaf and a pixel, and the teacher (``training/teacher.teacher_select``)
annotates the classical leaf; the summary reports the leaf agreement,
the hybrid's pixel shift and both modes' distance to the teacher point,
as the JAX tool does.

The CNN is a port checkpoint (default artifacts/torch/grasp_cnn/
best_model, the shipped JAX checkpoint converted by
tools/grasp_cnn_from_orbax.py; artifacts/torch/grasp_cnn_hard/best_model
is the hard-corpus ``deep`` model). A checkpoint that does not load
raises: seeded weights only with ``--random-init``. ``--check FILE``
holds every row against a committed record (artifacts/
system_accuracy*.json): the same scenes, and leaf, ``uv_cv``, ``uv_ml``
and ``teacher_uv`` equal.

    python tools/eval_system_accuracy_torch.py --check \\
        artifacts/system_accuracy.json
    python tools/eval_system_accuracy_torch.py --hard --arch deep \\
        --norm train_stats --ckpt artifacts/torch/grasp_cnn_hard/best_model
    python tools/eval_system_accuracy_torch.py --device cpu --scenes 3 \\
        --height 270 --width 360

Writes build/artifacts_torch/system_accuracy_torch.json (``--out``); the
last stdout line is the JSON summary; the exit code is 1 on a mismatch.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (CAMERA, OUT_DIR, TORCH_CNN,  # noqa: E402
                               add_device_arg, compare_rows, load_cnn,
                               print_summary, repo_path, setup_device,
                               write_json)

CHECK_EQUAL = ("leaf_cv", "leaf_ml", "uv_cv", "uv_ml", "teacher_uv")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=30)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--ckpt", default=None,
                    help="port checkpoint (default artifacts/torch/"
                         "grasp_cnn/best_model)")
    ap.add_argument("--random-init", action="store_true",
                    help="seeded weights instead of a checkpoint")
    ap.add_argument("--hard", action="store_true",
                    help="make_hard_leaf_scene scenes (clustered lobed "
                         "overlapping leaves)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--attention", default="spatial",
                    choices=["spatial", "channel", "hybrid", "none"])
    ap.add_argument("--arch", default="standard",
                    choices=["lightweight", "standard", "deep", "wide"])
    ap.add_argument("--norm", default="reference_minmax",
                    choices=["reference_minmax", "train_stats"],
                    help="serving patch normalization (geometry/"
                         "patches.py)")
    ap.add_argument("--check", default=None,
                    help="committed record to hold every row against")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            MLFusionConfig, ModelConfig,
                                            PipelineConfig)
    from leafgrasp_tpu_torch.io.scenes import (make_hard_leaf_scene,
                                               make_leaf_scene)
    from leafgrasp_tpu_torch.models.grasp_cnn import ARCHITECTURES
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.training.teacher import teacher_select
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    dev = setup_device(args.device)
    h, w = args.height, args.width
    area = 10000 if h >= 1080 else 1500
    cfg = PipelineConfig(frame=FrameConfig(height=h, width=w,
                                           max_leaves=8),
                         leaf=LeafSelectionConfig(min_leaf_area=area),
                         model=ModelConfig(
                             attention_type=args.attention,
                             encoder_filters=ARCHITECTURES[args.arch]),
                         fusion=MLFusionConfig(
                             patch_normalization=args.norm))
    cx, cy, f = (np.float32(v) for v in CAMERA)

    ckpt = repo_path(args.ckpt) if args.ckpt else TORCH_CNN
    model, norm_stats, src = load_cnn(ckpt, cfg.model, dev,
                                      random_init=args.random_init)
    if args.norm == "train_stats" and norm_stats is None:
        raise ValueError("--norm train_stats needs a checkpoint that "
                         "stores norm_stats (training/checkpoint.py)")
    cv_fn = make_frame_fn(cfg, with_cnn=False, device=dev)
    ml_fn = make_frame_fn(cfg, with_cnn=True, device=dev,
                          norm_stats=norm_stats)
    scene_fn = make_hard_leaf_scene if args.hard else make_leaf_scene

    rows = []
    t0 = time.perf_counter()
    for seed in range(args.scenes):
        n_leaves = (4, 6, 8)[seed % 3]
        mask, depth = scene_fn(h, w, num_leaves=n_leaves,
                               seed=100 + seed, margin=120)
        r_cv, r_ml = fetch_to_host((cv_fn(mask, depth, cx, cy, f),
                                    ml_fn(mask, depth, cx, cy, f, model)))
        if bool(r_cv.degenerate) or bool(r_ml.degenerate):
            continue
        uv_cv, uv_ml = r_cv.grasp_uv, r_ml.grasp_uv
        leaf_cv, leaf_ml = int(r_cv.leaf_id), int(r_ml.leaf_id)
        row = {"seed": 100 + seed, "n_leaves": n_leaves,
               "leaf_cv": leaf_cv, "leaf_ml": leaf_ml,
               "uv_cv": uv_cv.tolist(), "uv_ml": uv_ml.tolist()}
        # the teacher's point on the CLASSICAL leaf stands in for the
        # rig's human annotation
        t, _, _ = teacher_select(mask == leaf_cv, mask > 0, depth,
                                 cx, cy, f, cfg=cfg, device=dev)
        if t is not None:
            tx, ty = int(t[0]), int(t[1])
            row["teacher_uv"] = [tx, ty]
            row["cv_to_teacher_px"] = float(np.hypot(
                uv_cv[0] - tx, uv_cv[1] - ty))
            if leaf_ml == leaf_cv:
                row["ml_to_teacher_px"] = float(np.hypot(
                    uv_ml[0] - tx, uv_ml[1] - ty))
        rows.append(row)
        print(f"seed={row['seed']} leaves={n_leaves} "
              f"leaf cv/ml={leaf_cv}/{leaf_ml} "
              f"shift={abs(uv_cv[0]-uv_ml[0])+abs(uv_cv[1]-uv_ml[1])}",
              flush=True)
    wall = time.perf_counter() - t0

    agree = [r for r in rows if r["leaf_cv"] == r["leaf_ml"]]
    shifts = [float(np.hypot(r["uv_cv"][0] - r["uv_ml"][0],
                             r["uv_cv"][1] - r["uv_ml"][1]))
              for r in agree]
    cvt = [r["cv_to_teacher_px"] for r in rows if "cv_to_teacher_px" in r]
    mlt = [r["ml_to_teacher_px"] for r in rows if "ml_to_teacher_px" in r]
    summary = {
        "scenes": len(rows), "frame": [h, w], "hard_scenes": args.hard,
        "device": str(dev), "cnn_source": src,
        "cnn_config": {"attention": args.attention, "arch": args.arch},
        "patch_normalization": args.norm,
        "leaf_agreement": round(len(agree) / max(len(rows), 1), 4),
        "px_shift_mean": round(float(np.mean(shifts)), 2) if shifts
        else None,
        "px_shift_max": round(float(np.max(shifts)), 2) if shifts
        else None,
        "cv_to_teacher_px_mean": round(float(np.mean(cvt)), 2) if cvt
        else None,
        "ml_to_teacher_px_mean": round(float(np.mean(mlt)), 2) if mlt
        else None,
        "wall_s": wall,
    }
    if args.check:
        with open(repo_path(args.check)) as fh:
            record = json.load(fh)
        bad = compare_rows(rows, record["rows"],
                           range(100, 100 + args.scenes), CHECK_EQUAL)
        bad_seeds = {m["seed"] for m in bad}
        summary.update(record=args.check, rows_equal=sum(
            r["seed"] not in bad_seeds for r in rows), mismatches=bad)
    summary["rows"] = rows
    write_json(args.out or os.path.join(OUT_DIR,
                                        "system_accuracy_torch.json"),
               summary)
    print_summary(summary)
    return summary


if __name__ == "__main__":
    sys.exit(1 if main().get("mismatches") else 0)
