#!/usr/bin/env python3
"""Pretrain a tiny LLaVA-architecture base, then LoRA fine-tune it, on
the PyTorch port: the counterpart of tools/train_llava_lora.py at its
tiny configuration.

The same ``LlavaTorch`` architecture as the 7B model (CLIP-style tower,
projector, Mistral-style decoder; byte vocabulary) is trained on every
parameter on the synthetic scoring corpus (``LlavaLoRATrainer`` with
``train_full=True``), evaluated, then given rank-8 adapters
(``attach_lora``), LoRA-tuned on fresh scenes through the same trainer
and evaluated again. Writes, under ``--out``: ``llava_arch_adapter.npz``
(the JAX package's adapter format) with its ``.adapter_config.json``,
``llava_arch_base.pt`` (the pretrained base, a ``torch.save`` of its
``state_dict``) and ``llava_arch_lora.json`` (histories and metrics).

    python tools/train_llava_lora_torch.py                 # on the GPU
    python tools/train_llava_lora_torch.py --device cpu --train 16 \\
        --eval 4 --pretrain-epochs 1 --lora-epochs 1
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", type=int, default=300)
    ap.add_argument("--eval", type=int, default=32)
    ap.add_argument("--pretrain-epochs", type=int, default=12)
    ap.add_argument("--lora-epochs", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "llava_arch_torch"))
    args = ap.parse_args(argv)

    import torch
    from leafgrasp_tpu_torch.utils.device import resolve_device
    from leafgrasp_tpu_torch.vla.lm import ByteTokenizer
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     attach_lora,
                                                     init_random_)
    from leafgrasp_tpu_torch.vla.llava_trainer import LlavaLoRATrainer
    from leafgrasp_tpu_torch.vla.trainer import make_synthetic_vla_dataset

    dev = resolve_device(args.device)
    tok = ByteTokenizer()
    cfg = LlavaTorchConfig(
        vis_hidden=64, vis_intermediate=128, vis_layers=2, vis_heads=4,
        image_size=28, patch_size=14, vocab_size=272,
        hidden=128, intermediate=256, layers=3, heads=4, kv_heads=2,
        image_token_index=264, lora_rank=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_random_(LlavaTorch(cfg, device=dev), gen)

    train = make_synthetic_vla_dataset(args.train, seed=0,
                                       num_candidates=5, image_size=28)
    heldout = make_synthetic_vla_dataset(args.eval, seed=777,
                                         num_candidates=5, image_size=28)

    t0 = time.perf_counter()
    pre = LlavaLoRATrainer(model, tok, learning_rate=1e-3, max_len=600,
                           train_full=True, device=dev)
    hist = pre.fine_tune(train, epochs=args.pretrain_epochs, batch_size=8,
                         log_fn=lambda **kw: print("  pretrain", kw,
                                                   flush=True))
    base_eval = pre.evaluate(heldout)
    print("base:", base_eval, flush=True)

    lcfg = dataclasses.replace(cfg, lora_rank=8, lora_alpha=16.0)
    gen.manual_seed(1)
    lmodel = attach_lora(LlavaTorch(lcfg, device=dev), model.state_dict(),
                         gen)
    lora = LlavaLoRATrainer(lmodel, tok, learning_rate=5e-4, max_len=600,
                            device=dev)
    # adapter-tune on fresh scenes: adapt a pretrained base to new data
    # without touching it
    adapt = make_synthetic_vla_dataset(max(args.train // 2, 1), seed=101,
                                       num_candidates=5, image_size=28)
    lhist = lora.fine_tune(adapt, epochs=args.lora_epochs, batch_size=8,
                           log_fn=lambda **kw: print("  lora", kw,
                                                     flush=True))
    lora_eval = lora.evaluate(heldout)
    print("lora:", lora_eval, flush=True)

    os.makedirs(args.out, exist_ok=True)
    lora.save_adapter(os.path.join(args.out, "llava_arch_adapter.npz"))
    torch.save(model.state_dict(), os.path.join(args.out,
                                                "llava_arch_base.pt"))
    with open(os.path.join(args.out, "llava_arch_lora.json"), "w") as f:
        json.dump({
            "config": {k: getattr(cfg, k) for k in
                       ("vis_hidden", "vis_layers", "hidden", "layers",
                        "vocab_size", "image_size")},
            "device": str(dev),
            "pretrain": hist, "base_eval": base_eval,
            "lora": lhist, "lora_eval": lora_eval,
            "train_scenes": args.train, "eval_scenes": args.eval,
            "wall_s": round(time.perf_counter() - t0, 1),
        }, f, indent=2)
    out = {"base_top1": base_eval["top1_accuracy"],
           "lora_top1": lora_eval["top1_accuracy"], "chance": 0.2}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
