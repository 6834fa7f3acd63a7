#!/usr/bin/env python3
"""Train the standard GraspPointCNN through the full self-supervised
loop on the PyTorch port: the counterpart of
tools/train_reference_model.py.

The CV teacher labels synthetic 270 x 360 scenes (seeds 1000 + i, 4-6
leaves) into a resumable collector (a positive, three rotations and up
to three negatives a frame), the trainer fits the standard spatial CNN
(64/128/256) with the default training config, and the best epoch's
weights go into the port's checkpoint format.

    python tools/train_reference_model_torch.py              # on the GPU
    python tools/train_reference_model_torch.py --device cpu --frames 4 \\
        --epochs 1

Writes, under ``--out`` (default build/grasp_cnn_torch): the corpus
(``training_data/``), ``best_model`` with its ``.meta.json``,
``metrics.json`` and the dashboard PNG where matplotlib is installed. The
last stdout line is the JSON summary.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (ROOT, add_device_arg,  # noqa: E402
                               fit_and_save, repo_path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=170,
                    help="teacher frames the corpus holds (resumable)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the training config's")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "grasp_cnn_torch"))
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            ModelConfig, PipelineConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.training import (GraspDataCollector, Trainer,
                                              collect_from_frames)

    cfg = PipelineConfig(
        frame=FrameConfig(height=270, width=360, max_leaves=8),
        leaf=LeafSelectionConfig(min_leaf_area=1500))
    out_dir = repo_path(args.out)
    coll = GraspDataCollector(os.path.join(out_dir, "training_data"),
                              resume=True, save_every=1000,
                              device=args.device)
    have = coll.stats["positive_samples"]
    if have < args.frames:
        frames = (make_leaf_scene(270, 360, num_leaves=4 + s % 3,
                                  seed=1000 + s, margin=40)
                  for s in range(have, args.frames))
        used = collect_from_frames(frames, coll, 180.0, 135.0, 800.0, cfg)
        print(f"teacher labeled {used} new frames", flush=True)
    print("collection stats:", coll.stats, flush=True)

    trainer = Trainer(model_cfg=ModelConfig(), cfg=TrainConfig(),
                      device=args.device)
    record = fit_and_save(trainer, coll.dataset(), out_dir,
                          epochs=args.epochs,
                          info={"collection": dict(coll.stats)})
    print(json.dumps({k: record[k] for k in
                      ("best_val_loss", "best_epoch", "samples",
                       "epochs_run", "device", "checkpoint")}))
    return record


if __name__ == "__main__":
    main()
