#!/usr/bin/env python3
"""Render the sample composite through the PyTorch port: the
counterpart of tools/render_sample.py.

The regression scene (1080 x 1440, six leaves, seed 8) goes through the
port's CV-only frame function and ``LeafVisualizer``, with a synthetic
depth-shaded stand-in for the left-rectified image on the composite's
left half (reference visualizer.py:129-157).

    python tools/render_sample_torch.py                      # on the GPU
    python tools/render_sample_torch.py --device cpu

Writes a PNG (PIL) to ``--out`` (default build/artifacts_torch/
sample_composite.png); the last stdout line is the JSON summary.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (CAMERA, OUT_DIR,  # noqa: E402
                               add_device_arg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(OUT_DIR,
                                                  "sample_composite.png"))
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from PIL import Image
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.pipeline.visualizer import LeafVisualizer
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    cfg = DEFAULT_CONFIG
    mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                  num_leaves=6, seed=8, margin=120)
    fn = make_frame_fn(cfg, with_cnn=False, device=args.device)
    res = fetch_to_host(fn(mask, depth, *(np.float32(v) for v in CAMERA)))
    rgb = np.clip((depth - depth.min()) / (np.ptp(depth) + 1e-6), 0, 1)
    rgb = np.stack([0.3 + 0.5 * (mask > 0) * rgb, 0.25 + 0.55 * rgb,
                    0.3 * np.ones_like(rgb)], -1)
    tall = [i + 1 for i, t in enumerate(res.leaf_selection.is_tall) if t]
    frame = LeafVisualizer().render(
        mask, int(res.leaf_id), grasp_uv=res.grasp_uv,
        grasp_xyz=res.grasp_xyz, pre_grasp_xyz=res.pre_grasp_xyz,
        tall_leaves=tall, rgb=rgb)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(frame).save(args.out, optimize=True)
    summary = {"out": args.out, "shape": list(frame.shape),
               "leaf": int(res.leaf_id),
               "uv": [int(v) for v in res.grasp_uv], "tall_leaves": tall}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
