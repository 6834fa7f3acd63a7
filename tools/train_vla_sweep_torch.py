#!/usr/bin/env python3
"""Run the VLA LoRA sweep on the PyTorch port: the counterpart of
tools/train_vla_sweep.py, whose fixed arguments are flags here.

The four production experiments (``vla/experiments.py``) fine-tune
adapters on one shared base, pretrained first on every parameter (the
tiny-model analogue of LoRA-tuning the pretrained LLaVA), on synthetic
scene data; each experiment's adapter and history go under ``--out``
beside ``pretrained_base.npz`` and ``sweep_summary.json``, in the JAX
package's file formats.

    python tools/train_vla_sweep_torch.py                    # on the GPU
    python tools/train_vla_sweep_torch.py --device cpu --num-train 8 \\
        --num-eval 2 --pretrain-epochs 1

``--out`` defaults to build/vla_torch. The last stdout line is the JSON
summary.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import (ROOT, add_device_arg,  # noqa: E402
                               repo_path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-train", type=int, default=400)
    ap.add_argument("--num-eval", type=int, default=32)
    ap.add_argument("--pretrain-epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "vla_torch"))
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from leafgrasp_tpu_torch.vla.experiments import run_vla_sweep

    t0 = time.perf_counter()
    results = run_vla_sweep(
        repo_path(args.out), num_train=args.num_train,
        num_eval=args.num_eval, pretrain_epochs=args.pretrain_epochs,
        seed=args.seed, device=args.device,
        log_fn=lambda **kw: print("  ", kw, flush=True))
    for r in results:
        print(f"{r['experiment']:18s} loss {r['final_loss']:.3f} "
              f"top1 {r['top1_accuracy']:.2f} spearman "
              f"{r['spearman']:.3f}", flush=True)
    summary = {"experiments": [
        {k: r[k] for k in ("experiment", "final_loss", "top1_accuracy",
                           "spearman")} for r in results],
        "wall_s": time.perf_counter() - t0}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
