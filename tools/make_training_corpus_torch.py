#!/usr/bin/env python3
"""Build the hard self-supervised training corpus on the PyTorch port:
the counterpart of tools/make_training_corpus.py.

Scenes from ``make_hard_leaf_scene`` (clustered overlapping lobed
leaves, tilted noisy surfaces, speckle; seeds ``seed0`` + i, 5-8
leaves) are labelled by the CV teacher into a collector with the hard
negative pools (near-boundary points and tip-adjacent rings beside the
reference's tip, stem and edge negatives).

    python tools/make_training_corpus_torch.py [--frames 220]
    python tools/make_training_corpus_torch.py --device cpu --frames 2 \\
        --fresh --out /tmp/corpus

Writes ``training_data.npz`` and its metadata under ``--out`` (default
build/grasp_cnn_hard_torch/training_data). The last stdout line is the
JSON summary.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (ROOT, add_device_arg,  # noqa: E402
                               repo_path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=360)
    ap.add_argument("--seed0", type=int, default=5000)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "grasp_cnn_hard_torch", "training_data"))
    ap.add_argument("--fresh", action="store_true",
                    help="discard any existing corpus at --out")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            PipelineConfig)
    from leafgrasp_tpu_torch.io.scenes import make_hard_leaf_scene
    from leafgrasp_tpu_torch.training import (GraspDataCollector,
                                              collect_from_frames,
                                              verify_dataset)

    cfg = PipelineConfig(
        frame=FrameConfig(height=args.height, width=args.width,
                          max_leaves=10),
        leaf=LeafSelectionConfig(min_leaf_area=1500))
    out = repo_path(args.out)
    coll = GraspDataCollector(out, resume=not args.fresh,
                              save_every=10_000, hard_negatives=True,
                              device=args.device)
    have = coll.stats["positive_samples"]
    if have < args.frames:
        frames = (make_hard_leaf_scene(
            args.height, args.width, num_leaves=5 + s % 4,
            seed=args.seed0 + s, margin=40)
            for s in range(have, args.frames))
        used = collect_from_frames(frames, coll, args.width / 2.0,
                                   args.height / 2.0, 800.0, cfg)
        print(f"teacher labeled {used} new frames", flush=True)
    coll.save()
    print("collection stats:", coll.stats, flush=True)

    data = coll.dataset()
    report = verify_dataset(data)
    print("verify:", report, flush=True)
    if not report["ok"]:
        raise ValueError(f"corpus fails verification: {report['problems']}")
    n = len(data["labels"])
    pos = int(data["labels"].sum())
    summary = {"samples": n, "positive": pos, "negative": n - pos,
               "stats": dict(coll.stats), "device": str(coll.device),
               "path": os.path.join(out, "training_data.npz")}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
