#!/usr/bin/env python3
"""End-to-end demo of the PyTorch/CUDA port: synthetic scene -> grasp
service -> published message -> visualization.

    python examples/run_pipeline_demo_torch.py            # on the GPU
    python examples/run_pipeline_demo_torch.py --device cpu

The counterpart of ``run_pipeline_demo.py``: it builds a ``GraspService``
(with the standard CNN, seeded weights, unless ``--cv-only``), pushes one
mask / depth pair through the frame bus, prints the published message
and the stage timings, and writes the composite PNG when Pillow is
installed. Without ``--device`` it runs on CUDA and fails if there is
none. The first frame on the GPU builds the CUDA kernels with ``nvcc``
into ``build/kernels/``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, load_config
    from leafgrasp_tpu_torch.io.scenes import (default_projection,
                                               make_leaf_scene)
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_random_)
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.pipeline.visualizer import LeafVisualizer
    from leafgrasp_tpu_torch.utils.device import device_info, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="YAML/JSON config file (e.g. configs/baseline.yaml)")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    ap.add_argument("--cv-only", action="store_true",
                    help="run without the CNN")
    ap.add_argument("--hist-median", action="store_true",
                    help="per-leaf median depths from the histogram "
                         "kernel instead of the bisection")
    ap.add_argument("--out", default="~/leafgrasp_out/vis_torch",
                    help="directory for the visualization PNG")
    args = ap.parse_args()

    cfg = load_config(args.config) if args.config else DEFAULT_CONFIG
    dev = resolve_device(args.device)
    print("device:", device_info(dev))
    mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                  num_leaves=6, seed=8)
    cnn = None
    if not args.cv_only:
        cnn = init_random_(GraspPointCNN(cfg.model), seed=0).to(dev).eval()

    svc = GraspService(cfg, cnn=cnn, device=dev,
                       hist_median=args.hist_median,
                       publish=lambda m: print("publish:", m))
    print("frame bus:", "native" if svc.bus.is_native else "python")
    svc.set_camera_params(default_projection())
    svc.on_mask(mask)
    svc.on_depth(depth)
    out = svc.process_pending(force=True)
    svc.stop()
    if out is None or not out["found"]:
        print("no grasp found")
        return

    res = out["result"]
    print(f"leaf {int(res.leaf_id)}  uv {res.grasp_uv}  "
          f"3d {res.grasp_xyz.round(4)}  pre {res.pre_grasp_xyz.round(4)}  "
          f"degenerate={bool(res.degenerate)}")

    tall = [i + 1 for i, t in enumerate(res.leaf_selection.is_tall) if t]
    vis = LeafVisualizer(os.path.expanduser(args.out))
    frame = vis.render(mask, int(res.leaf_id), res.grasp_uv, res.grasp_xyz,
                       res.pre_grasp_xyz, tall_leaves=tall)
    try:
        print("visualization:", vis.save(frame))
    except ImportError:
        print(f"visualization rendered {frame.shape}; Pillow is not "
              "installed, so no PNG was written")
    print(svc.timer.report())


if __name__ == "__main__":
    main()
