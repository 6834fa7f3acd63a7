#!/usr/bin/env python3
"""Randomized frames through the PyTorch port, the counterpart of
tools/fuzz_parity.py.

The same draws as the JAX fuzzer, from ``np.random.default_rng(seed0)``:
per case a scene seed, a leaf count (3-10), a margin, the principal
point and the focal length, one frame shape per run, ``max_leaves=12``.
Each case goes through the port's frame function; its found and
degenerate counts are held against the committed record's stats
(``--check``, default artifacts/fuzz_parity.json, compared when the
record was drawn with the same parameters). ``--cross-check N`` runs the
first N cases on the port's CPU path too and holds the found flag, the
degenerate flag, the leaf, the pixel and the published message (the JAX
parity rule) against it. The oracle comparison of the JAX tool lives in
the tests (tests/test_torch_tools_eval.py), which import the oracle.

    python tools/fuzz_parity_torch.py --n 100 --cross-check 10
    python tools/fuzz_parity_torch.py --device cpu --n 3 --h 270 --w 360

Writes build/artifacts_torch/fuzz_parity_torch.json; the last stdout
line is the JSON summary; the exit code is 1 on any mismatch.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (OUT_DIR, add_device_arg,  # noqa: E402
                               message_match, print_summary, repo_path,
                               setup_device, write_json)


def draw_cases(n: int, h: int, w: int, seed0: int):
    """The JAX fuzzer's cases (tools/fuzz_parity.py:66-75), in order."""
    rng = np.random.default_rng(seed0)
    lo, hi = int(0.10 * min(h, w)), int(0.35 * min(h, w))
    for i in range(n):
        scene_seed = int(rng.integers(0, 100000))
        n_leaves = int(rng.integers(3, 11))
        margin = int(rng.integers(lo, hi + 1))
        cx = float(w / 2 + rng.uniform(-30, 30))
        cy = float(h / 2 + rng.uniform(-30, 30))
        f = float(rng.uniform(600, 1800))
        yield {"i": i, "scene_seed": scene_seed, "n_leaves": n_leaves,
               "margin": margin, "cx": cx, "cy": cy, "f": f}


def case_answer(fn, mask, depth, case) -> dict:
    from leafgrasp_tpu_torch.pipeline.ingest import format_result_message
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    res = fetch_to_host(fn(mask, depth, np.float32(case["cx"]),
                           np.float32(case["cy"]), np.float32(case["f"])))
    return {"found": bool(res.found), "degenerate": bool(res.degenerate),
            "leaf": int(res.leaf_id),
            "uv": [int(v) for v in res.grasp_uv],
            "message": format_result_message(res.grasp_uv, res.grasp_xyz,
                                             res.pre_grasp_xyz)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--h", type=int, default=540)
    ap.add_argument("--w", type=int, default=720)
    ap.add_argument("--min-area", type=int, default=1500)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--cross-check", type=int, default=0,
                    help="hold the first N cases against the CPU path")
    ap.add_argument("--check", default="artifacts/fuzz_parity.json")
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    H, W = args.h, args.w

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            PipelineConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn

    dev = setup_device(args.device)
    cfg = PipelineConfig(frame=FrameConfig(height=H, width=W, max_leaves=12),
                         leaf=LeafSelectionConfig(
                             min_leaf_area=args.min_area))
    fn = make_frame_fn(cfg, with_cnn=False, device=dev)
    cpu_fn = make_frame_fn(cfg, with_cnn=False, device="cpu") \
        if args.cross_check else None

    rows, mismatches = [], []
    t0 = time.perf_counter()
    for case in draw_cases(args.n, H, W, args.seed0):
        mask, depth = make_leaf_scene(height=H, width=W,
                                      num_leaves=case["n_leaves"],
                                      seed=case["scene_seed"],
                                      margin=case["margin"])
        row = {**case, **case_answer(fn, mask, depth, case)}
        rows.append(row)
        if case["i"] < args.cross_check:
            cpu = case_answer(cpu_fn, mask, depth, case)
            bad = [k for k in ("found", "degenerate", "leaf", "uv")
                   if cpu[k] != row[k]]
            if not message_match(cpu["message"], row["message"]):
                bad.append("message")
            if bad:
                mismatches.append({"i": case["i"], "kind": "cpu",
                                   "fields": bad, "ours": row, "cpu": cpu})
    wall = time.perf_counter() - t0

    found = sum(r["found"] for r in rows)
    stats = {"n": len(rows), "empty": len(rows) - found,
             "degenerate": sum(r["found"] and r["degenerate"]
                               for r in rows)}
    params = {"n": args.n, "h": H, "w": W, "min_area": args.min_area,
              "seed0": args.seed0}
    with open(repo_path(args.check)) as f:
        record = json.load(f)
    compared = record["params"] == params
    if compared:
        for key in ("n", "empty", "degenerate"):
            if stats[key] != record["stats"][key]:
                mismatches.append({"kind": "stats", "field": key,
                                   "ours": stats[key],
                                   "record": record["stats"][key]})
    summary = {"params": params, "device": str(dev), "stats": stats,
               "record": args.check, "record_stats": record["stats"],
               "stats_compared": compared,
               "cross_checked": min(args.cross_check, len(rows)),
               "mismatch_count": len(mismatches), "mismatches": mismatches,
               "wall_s": wall, "rows": rows}
    write_json(args.out or os.path.join(OUT_DIR, "fuzz_parity_torch.json"),
               summary)
    print(f"found {found}/{len(rows)}, degenerate {stats['degenerate']} "
          f"(record: empty {record['stats']['empty']}, degenerate "
          f"{record['stats']['degenerate']} of {record['stats']['n']}"
          f"{'' if compared else '; other parameters, not compared'})")
    print_summary(summary, drop=("rows", "mismatches"))
    return summary


if __name__ == "__main__":
    sys.exit(1 if main()["mismatch_count"] else 0)
