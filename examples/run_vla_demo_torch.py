#!/usr/bin/env python3
"""VLA hybrid-selection demo on the PyTorch port: the counterpart of
examples/run_vla_demo.py.

Runs the three scorer backends (stub, heuristic, TinyVLA) on synthetic
candidates through ``HybridGraspSelector`` and shows the confidence
ladder and the two degradations; then LoRA fine-tunes a small TinyVLA
(``VLATrainer``: real forward and backward passes), evaluates it and
saves its adapter in the JAX package's ``.npz`` format.

    python examples/run_vla_demo_torch.py              # on the GPU
    python examples/run_vla_demo_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_sample(seed: int = 0, num_candidates: int = 5,
                     image_size: int = 64):
    """One synthetic leaf scene with scored candidates (the first sample
    of the JAX package's ``make_synthetic_vla_dataset``)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.3, (image_size, image_size, 3)) \
        .astype(np.float32)
    candidates = []
    margin = max(2, min(8, image_size // 4))
    for _ in range(num_candidates):
        cx, cy = rng.integers(margin, image_size - margin, 2)
        clutter = float(rng.uniform(0.2, 1.0))
        distance = float(rng.uniform(0.2, 1.0))
        visibility = float(rng.uniform(0.2, 1.0))
        gt = 0.35 * clutter + 0.35 * distance + 0.3 * visibility
        img[max(cy - 4, 0):cy + 4, max(cx - 4, 0):cx + 4, 1] += 0.4
        candidates.append(dict(
            x=int(cx), y=int(cy), clutter_score=clutter,
            distance_score=distance, visibility_score=visibility,
            geometric_score=gt))
    return np.clip(img, 0, 1), candidates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "vla_demo_torch"),
        help="directory of the fine-tuned adapter")
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.vla import (HybridGraspSelector, VLAProcessor,
                                         StubScorer, HeuristicScorer,
                                         TinyVLAScorer)

    image, candidates = synthetic_sample(0)
    picks = {}
    for name, backend in (("stub (degraded)", StubScorer()),
                          ("heuristic", HeuristicScorer()),
                          ("tiny-vla", TinyVLAScorer(device=args.device))):
        sel = HybridGraspSelector(VLAProcessor(backend))
        best = sel.select_grasp_point(image, candidates)
        picks[name] = best
        print(f"{name:18s} -> leaf@({best['x']},{best['y']}) "
              f"strategy={best['strategy']} "
              f"conf={best['vla_confidence']:.3f} "
              f"weights vla={best['vla_weight']:.2f}")

    class Boom:
        def score(self, *a, **k):
            raise RuntimeError("backend failure injection")

    best = HybridGraspSelector(VLAProcessor(Boom())) \
        .select_grasp_point(image, candidates)
    print(f"{'failing backend':18s} -> leaf@({best['x']},{best['y']}) "
          f"strategy={best['strategy']} (uniform 0.5 scores)")
    picks["failing backend"] = best

    from leafgrasp_tpu_torch.vla import (VLAModelConfig, VLATrainer,
                                         make_synthetic_vla_dataset)
    print("\nLoRA fine-tune (real forward/backward):")
    cfg = VLAModelConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                         mlp_hidden=128, vision_tokens=4,
                         vision_patch=32, lora_rank=8, max_seq=600)
    trainer = VLATrainer(cfg=cfg, learning_rate=1e-3, device=args.device)
    train = make_synthetic_vla_dataset(8, seed=1)
    trainer.fine_tune(train, epochs=2, log_fn=lambda **kw: print(
        f"  epoch {kw['epoch']} loss {kw['loss']:.4f}"))
    print("eval:", trainer.evaluate(make_synthetic_vla_dataset(4, seed=2)))
    path = os.path.join(args.out, "adapter.npz")
    trainer.save_adapter(path)
    print(f"adapter saved to {path}")
    return picks


if __name__ == "__main__":
    main()
