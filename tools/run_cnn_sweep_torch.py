#!/usr/bin/env python3
"""Run the 64-config GraspPointCNN sweep on the PyTorch port: the
counterpart of tools/run_cnn_sweep.py (the reference's MLflow grid,
train_model_mlflow.py:499-589).

Every config (4 attention types x 4 architectures x 4 learning-rate /
batch pairs) is trained on the collected patch corpus; the JSONL store
and the top-10 summary go under ``--out``.

    python tools/run_cnn_sweep_torch.py [--epochs 20] [--limit N]
    python tools/run_cnn_sweep_torch.py --device cpu --limit 2 --epochs 1

``--out`` defaults to build/experiments_torch. The last stdout line is
the JSON summary.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (ROOT, add_device_arg,  # noqa: E402
                               load_corpus, repo_path)

_KEYS = ("depth_patches", "mask_patches", "score_patches", "labels")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--data", default="artifacts/grasp_cnn/"
                    "training_data/training_data.npz")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "experiments_torch"))
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.training import (ExperimentTracker,
                                              generate_experiment_configs,
                                              run_sweep)

    corpus = load_corpus(args.data)
    ds = {k: corpus[k] for k in _KEYS}
    configs = generate_experiment_configs()
    print(f"dataset: {len(ds['labels'])} samples "
          f"({int(ds['labels'].sum())} positive); {len(configs)} configs "
          f"x {args.epochs} epochs", flush=True)
    tracker = ExperimentTracker(repo_path(args.out))
    t0 = time.perf_counter()
    results = run_sweep(ds, tracker, configs=configs, epochs=args.epochs,
                        limit=args.limit, device=args.device)
    path = tracker.write_summary()
    best = tracker.top_k(1)[0]
    summary = {"runs": len(results), "epochs": args.epochs,
               "best": best["run"],
               "best_f1": best["final"].get("f1_score"),
               "summary": path, "wall_s": time.perf_counter() - t0}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
