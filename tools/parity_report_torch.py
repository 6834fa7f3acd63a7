#!/usr/bin/env python3
"""Parity report of the PyTorch port against the JAX package's records.

The counterpart of tools/parity_report.py. The golden scenes (or the
production ones) go through the port's frame function (CV-only,
``make_frame_fn(cfg, with_cnn=False)``), and each scene's answer is held
against the committed record's row (PARITY.json / PARITY_production.json):

* JAX's answer: leaf (``ours_leaf``), grasp pixel (``ours_uv``) and the
  degenerate flag equal; the published message (``ours_message``) by the
  JAX rule: pixel equal, every float within 1e-5 relative;
* the oracle's answer (``exact``: tests/reference_impl.py with the exact
  EDT): its leaf equal where the row has ``leaf_match``, its pixel equal
  where the row has ``uv_match``.

The oracle itself (OpenCV, the JAX convolutions) stays in the tests; this
tool reads only what it recorded. It writes its own rows under
``build/artifacts_torch/`` and never the committed records.

    python tools/parity_report_torch.py [--scale golden|production]
    python tools/parity_report_torch.py --device cpu --seeds 0,28,30

The last stdout line is the JSON summary; the exit code is 1 on any
mismatch.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (OUT_DIR, ROOT,  # noqa: E402
                               add_device_arg, message_match,
                               print_summary, repo_path, setup_device,
                               write_json)

GOLDEN = {
    # tools/parity_report.py GOLDEN: seed 28 is the degenerate scene
    "scenes": [(s, 4) for s in (0, 30, 3, 5, 7, 11, 13, 17, 19, 23)]
    + [(s, 6) for s in (29, 31, 8, 33, 14, 16, 20, 22)]
    + [(s, 8) for s in (2, 9, 34, 36)]
    + [(s, 3) for s in (25, 26, 27, 28)],
    "h": 270, "w": 360, "cx": 180.0, "cy": 135.0, "f": 800.0,
    "area": 1500, "margin": 40, "record": "PARITY.json",
}
PRODUCTION = {
    "scenes": [(s, 4) for s in (0, 3, 37, 13)]
    + [(s, 6) for s in (39, 8, 14, 20)]
    + [(s, 8) for s in (38, 9, 15, 18)]
    + [(s, 3) for s in (25, 26, 40, 28)],
    "h": 1080, "w": 1440, "cx": 707.87, "cy": 494.07, "f": 1750.68,
    "area": 10000, "margin": 80, "record": "PARITY_production.json",
}


def scene_row(seed, n_leaves, res) -> dict:
    """The port's answer for one scene, in the record's field names."""
    from leafgrasp_tpu_torch.pipeline.ingest import format_result_message
    uv = [int(v) for v in res.grasp_uv]
    return {"seed": seed, "n_leaves": n_leaves,
            "ours_leaf": int(res.leaf_id), "ours_uv": uv,
            "ours_xyz": [float(v) for v in res.grasp_xyz],
            "ours_pre_grasp": [float(v) for v in res.pre_grasp_xyz],
            "ours_message": format_result_message(
                res.grasp_uv, res.grasp_xyz, res.pre_grasp_xyz),
            "degenerate": bool(res.degenerate)}


def row_mismatches(row: dict, want: dict) -> list:
    """The fields of ``row`` that disagree with the record's row."""
    bad = []
    for key in ("ours_leaf", "ours_uv", "degenerate"):
        if row[key] != want[key]:
            bad.append({"field": key, "ours": row[key],
                        "record": want[key]})
    if not message_match(want["ours_message"], row["ours_message"]):
        bad.append({"field": "ours_message", "ours": row["ours_message"],
                    "record": want["ours_message"]})
    exact = want.get("exact", {})
    if exact.get("leaf_match") and row["ours_leaf"] != exact["leaf"]:
        bad.append({"field": "exact.leaf", "ours": row["ours_leaf"],
                    "record": exact["leaf"]})
    if exact.get("uv_match") and row["ours_uv"] != list(exact["uv"]):
        bad.append({"field": "exact.uv", "ours": row["ours_uv"],
                    "record": exact["uv"]})
    return bad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=("golden", "production"),
                    default="golden")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds: only these scenes of the "
                         "set")
    ap.add_argument("--check", default=None,
                    help="record to hold the rows against (default the "
                         "scale's committed PARITY*.json)")
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    P = GOLDEN if args.scale == "golden" else PRODUCTION
    H, W, AREA = P["h"], P["w"], P["area"]

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            PipelineConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    dev = setup_device(args.device)
    scenes = P["scenes"]
    if args.seeds:
        keep = {int(s) for s in args.seeds.split(",")}
        scenes = [sc for sc in scenes if sc[0] in keep]
        if len(scenes) != len(keep):
            raise ValueError(f"seeds {sorted(keep)} are not all in the "
                             f"{args.scale} set")
    record_path = repo_path(args.check or P["record"])
    with open(record_path) as f:
        want = {r["seed"]: r for r in json.load(f)["rows"]}

    cfg = PipelineConfig(frame=FrameConfig(height=H, width=W, max_leaves=8),
                         leaf=LeafSelectionConfig(min_leaf_area=AREA))
    fn = make_frame_fn(cfg, with_cnn=False, device=dev)
    rows = []
    t0 = time.perf_counter()
    for seed, n_leaves in scenes:
        mask, depth = make_leaf_scene(height=H, width=W,
                                      num_leaves=n_leaves, seed=seed,
                                      margin=P["margin"])
        res = fetch_to_host(fn(mask, depth, P["cx"], P["cy"], P["f"]))
        row = scene_row(seed, n_leaves, res)
        row["mismatches"] = row_mismatches(row, want[seed])
        rows.append(row)
        print(f"seed={seed:3d} leaves={n_leaves} leaf={row['ours_leaf']} "
              f"uv={row['ours_uv']} degenerate={row['degenerate']} "
              f"mismatches={len(row['mismatches'])}", flush=True)
    wall = time.perf_counter() - t0

    def agree(field):
        return sum(not any(m["field"] == field for m in r["mismatches"])
                   for r in rows)

    oracle_rows = [r for r in rows if want[r["seed"]].get(
        "exact", {}).get("uv_match")]
    summary = {
        "scale": args.scale, "frame": [H, W], "min_area": AREA,
        "camera": [P["cx"], P["cy"], P["f"]], "device": str(dev),
        "record": os.path.relpath(record_path, ROOT),
        "scenes": len(rows),
        "degenerate_scenes": sum(r["degenerate"] for r in rows),
        "leaf_equal": agree("ours_leaf"), "uv_equal": agree("ours_uv"),
        "degenerate_equal": agree("degenerate"),
        "message_equal": agree("ours_message"),
        "oracle_uv_rows": len(oracle_rows),
        "oracle_uv_equal": sum(not any(m["field"] == "exact.uv"
                                       for m in r["mismatches"])
                               for r in oracle_rows),
        "mismatches": sum(len(r["mismatches"]) for r in rows),
        "wall_s": wall, "rows": rows,
    }
    name = "PARITY_torch.json" if args.scale == "golden" \
        else "PARITY_production_torch.json"
    write_json(args.out or os.path.join(OUT_DIR, name), summary)
    print_summary(summary)
    return summary


if __name__ == "__main__":
    sys.exit(1 if main()["mismatches"] else 0)
