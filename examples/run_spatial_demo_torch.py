#!/usr/bin/env python3
"""Row-sharded single-frame pipeline demo on the PyTorch port: the
counterpart of examples/run_spatial_demo.py.

One frame's rows are partitioned over the data axis of a mesh of ranks
(``parallel/launch.run_ranks``: one process a rank, ``torch.distributed``
over gloo, ranks sharing the card or the CPU); the whole frame program
(leaf Pareto selection, score maps, spaced top-k, 3D lift, pre-grasp)
runs on each rank's rows with halo exchanges and collectives
(``parallel/spatial_frame.make_sharded_frame_fn``), and rank 0 holds the
result against the single-device ``make_frame_fn``: leaf, pixel and 3D
point equal.

    python examples/run_spatial_demo_torch.py               # on the GPU
    python examples/run_spatial_demo_torch.py --device cpu --ranks 4

The last stdout line is the JSON summary.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def frame_config(shards: int):
    """The JAX demo's frame: 1080 x 360 (135 rows a shard where 1080
    does not divide), 1500-pixel leaves."""
    from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG, FrameConfig,
                                            LeafSelectionConfig)
    h = 135 * shards if 1080 % shards else 1080
    return DEFAULT_CONFIG.replace(
        frame=FrameConfig(height=h, width=360, max_leaves=8),
        leaf=LeafSelectionConfig(min_leaf_area=1500))


def scene(h: int):
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    mask, depth = make_leaf_scene(h, 360, num_leaves=5, seed=8, margin=40)
    return mask, depth, (np.float32(180.0), np.float32(h / 2.0),
                         np.float32(430.0))


def answer(res) -> dict:
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    res = fetch_to_host(res)
    return {"leaf": int(res.leaf_id),
            "uv": [int(v) for v in res.grasp_uv],
            "xyz": [float(v) for v in res.grasp_xyz],
            "found": bool(res.found)}


def rank_main(rank, world, device):
    """One rank: the sharded frame on the mesh; rank 0 adds the
    single-device frame."""
    import torch
    from leafgrasp_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from leafgrasp_tpu_torch.parallel.spatial_frame import \
        make_sharded_frame_fn
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(world, model_axis=1, device=device)
    cfg = frame_config(world)
    mask, depth, cam = scene(cfg.frame.height)
    fn = make_sharded_frame_fn(mesh, cfg, with_cnn=False)
    out = {"sharded": answer(fn(mask, depth, *cam)),
           "collectives": fn.axis.calls}
    if rank == 0:
        single = make_frame_fn(cfg, with_cnn=False,
                               device=mesh_device(mesh))
        out["single"] = answer(single(mask, depth, *cam))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="default CUDA (raises without it)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the whole run")
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.parallel.launch import run_ranks
    from leafgrasp_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    cfg = frame_config(args.ranks)
    h = cfg.frame.height
    store = os.path.join("build", f"spatial_demo_store_{os.getpid()}")
    os.makedirs("build", exist_ok=True)
    outs = run_ranks(rank_main, args.ranks, store, args.device,
                     backend="gloo", timeout_s=60.0, join_s=args.timeout,
                     threads=1 if args.device == "cpu" else 0)
    sharded, single = outs[0]["sharded"], outs[0]["single"]
    print(f"mesh: {args.ranks} ranks on {args.device}  frame: {h}x360 "
          f"({h // args.ranks} rows/shard)")
    print(f"sharded : leaf {sharded['leaf']}  uv {sharded['uv']}  3d "
          f"{np.round(sharded['xyz'], 4).tolist()}")
    print(f"single  : leaf {single['leaf']}  uv {single['uv']}  3d "
          f"{np.round(single['xyz'], 4).tolist()}")
    same = sharded == single and all(o["sharded"] == sharded for o in outs)
    print("row-sharded == single-device:", same)
    summary = {"ranks": args.ranks, "device": args.device,
               "frame": [h, 360], "sharded": sharded, "single": single,
               "collectives": outs[0]["collectives"], "equal": same}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["equal"] else 1)
