#!/usr/bin/env python3
"""Train ONE GraspPointCNN config on a collected corpus on the PyTorch
port and write its checkpoint: the counterpart of
tools/train_best_config.py (the full-epoch follow-up to a sweep's
winner).

    python tools/train_best_config_torch.py \\
        --data artifacts/grasp_cnn_hard/training_data/training_data.npz \\
        [--attention spatial --arch standard --lr 5e-4 --batch 16
         --pos-weight 2.0 --wd 0.01 --epochs 150]

Writes, under ``--out`` (default build/grasp_cnn_best_torch):
``best_model`` (the port's checkpoint format) with its ``.meta.json``,
``metrics.json`` and the dashboard PNG where matplotlib is installed.
The last stdout line is the JSON summary.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (ROOT, add_device_arg,  # noqa: E402
                               fit_and_save, load_corpus, repo_path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "grasp_cnn_best_torch"))
    ap.add_argument("--attention", default="spatial",
                    choices=["spatial", "channel", "hybrid", "none"])
    ap.add_argument("--arch", default="standard",
                    choices=["lightweight", "standard", "deep", "wide"])
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pos-weight", type=float, default=2.0)
    ap.add_argument("--wd", type=float, default=0.01)
    ap.add_argument("--epochs", type=int, default=150)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import ARCHITECTURES
    from leafgrasp_tpu_torch.training import Trainer

    trainer = Trainer(
        model_cfg=ModelConfig(attention_type=args.attention,
                              encoder_filters=ARCHITECTURES[args.arch]),
        cfg=TrainConfig(learning_rate=args.lr, batch_size=args.batch,
                        pos_weight=args.pos_weight,
                        weight_decay=args.wd, epochs=args.epochs),
        device=args.device)
    config = {"attention": args.attention, "arch": args.arch,
              "lr": args.lr, "batch": args.batch,
              "pos_weight": args.pos_weight, "wd": args.wd}
    record = fit_and_save(trainer, load_corpus(args.data),
                          repo_path(args.out), epochs=args.epochs,
                          info={"config": config})
    print(json.dumps({k: record[k] for k in
                      ("best_val_loss", "best_epoch", "samples",
                       "epochs_run", "device", "checkpoint")}))
    return record


if __name__ == "__main__":
    main()
