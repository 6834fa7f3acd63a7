#!/usr/bin/env python3
"""Self-supervised training demo on the PyTorch port: CV teacher ->
collector -> CNN trainer -> checkpoint, the counterpart of
examples/run_training_demo.py.

    python examples/run_training_demo_torch.py              # on the GPU
    python examples/run_training_demo_torch.py --device cpu

The teacher labels synthetic 270 x 360 scenes (leaf selection and score
maps through the port's kernels on the card), the collector adds
rotations and negatives, the trainer fits the GraspPointCNN (the
standard architecture; ``--small`` takes (8, 16) filters), and the best
weights go into the port's checkpoint format, reloaded through
``GraspQualityPredictor``. The dashboard PNG is written where matplotlib
is installed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--small", action="store_true",
                    help="(8, 16) filters instead of the standard model")
    ap.add_argument("--out", default=os.path.join("build", "training_demo"))
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.config import (FrameConfig, LeafSelectionConfig,
                                            ModelConfig, PipelineConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    from leafgrasp_tpu_torch.training import (GraspDataCollector, Trainer,
                                              collect_from_frames,
                                              save_checkpoint,
                                              verify_dataset)
    from leafgrasp_tpu_torch.training.checkpoint import best_model_path

    cfg = PipelineConfig(
        frame=FrameConfig(height=270, width=360, max_leaves=8),
        leaf=LeafSelectionConfig(min_leaf_area=1500))
    cx, cy, f = 180.0, 135.0, 800.0
    frames = [make_leaf_scene(270, 360, 4, seed=s, margin=40)
              for s in range(args.frames)]
    coll = GraspDataCollector(os.path.join(args.out, "ml_training_data"),
                              resume=False, device=args.device)
    used = collect_from_frames(frames, coll, cx, cy, f, cfg)
    print(f"teacher labeled {used} frames -> {len(coll.samples)} samples "
          f"({coll.stats}) on {coll.device}")
    data = coll.dataset()
    report = verify_dataset(data)
    print("dataset ok:", report["ok"], "| pos", report["positive"],
          "neg", report["negative"])

    model_cfg = ModelConfig(encoder_filters=(8, 16)) if args.small \
        else ModelConfig()
    trainer = Trainer(model_cfg, TrainConfig(batch_size=16,
                                             epochs=args.epochs),
                      device=args.device)
    result = trainer.fit(data, epochs=args.epochs,
                         log_fn=lambda **kw: print(
                             f"epoch {kw['epoch']:3d} train_loss "
                             f"{kw['train_loss']:.4f} val_loss "
                             f"{kw['val_loss']:.4f} f1 "
                             f"{kw['f1_score']:.1f}"))
    print("best val loss:", result.best_val_loss, "at epoch",
          result.best_epoch)
    models = os.path.join(args.out, "ml_models")
    path = save_checkpoint(best_model_path(models),
                           result.model.state_dict(),
                           optimizer_state=result.optimizer_state,
                           norm_stats=result.norm_stats,
                           metrics=result.metrics, history=result.history,
                           epoch=result.best_epoch)
    pred = GraspQualityPredictor(model_cfg, device=args.device).load(path)
    score = pred.predict({"depth_patch": data["depth_patches"][0],
                          "mask_patch": data["mask_patches"][0],
                          "score_patches": data["score_patches"][0]})
    print(f"checkpoint written to {path}; reloaded, the first sample "
          f"(label {data['labels'][0]}) scores {score:.3f}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no dashboard")
    else:
        from leafgrasp_tpu_torch.training import plot_metrics
        print("dashboard:", plot_metrics(result.history, models))
    return {"samples": len(coll.samples), "checkpoint": path,
            "best_val_loss": result.best_val_loss}


if __name__ == "__main__":
    main()
