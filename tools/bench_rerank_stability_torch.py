#!/usr/bin/env python3
"""Batched-against-sequential rerank stability of the PyTorch port's
serving scorer: the counterpart of tools/bench_rerank_stability.py.

``LlavaTorchScorer`` left-pads the five candidate prompts of a frame into
ONE generate; the reference runs the model once a candidate. Masking
makes the two the same function, but a product's tiling changes with the
batch shape, and in bf16 that can flip a greedy argmax on a near-tie.
For N frames of random candidates (fixed token shapes), the scorer runs
at batch 5 and at ``max_batch=1`` over the same prompts, the same random
weights and ONE shared image-feature tensor, and reports:

* the score flip rate: candidates whose parsed score differs (the stub
  tokenizer's decode is injective, so a score flip is a token flip);
* the first-step logits' largest difference between the two batchings,
  in units of the logits' own standard deviation.

bf16 and (``--int8``) weight-only int8. Prints the JAX tool's list of
records, each with ``device`` (the card's name and power limit).

    python tools/bench_rerank_stability_torch.py [--frames 20]
        [--layers 32 --hidden 4096 | --tiny] [--int8] [--skip-bf16]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tools._torch_bench import (TINY_LLAVA, FixedLenTok,  # noqa: E402
                                device_stamp, free_memory)
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402

FEATURE_SEED_OFFSET = 77     # the image's seed is seed + 77, as in JAX


def make_candidates(rng, n=5):
    """n random candidates on a 1080 x 1440 frame
    (bench_rerank_stability.py:66)."""
    return [dict(x=int(rng.integers(0, 1440)),
                 y=int(rng.integers(0, 1080)),
                 geometric_score=float(rng.uniform(0, 1)),
                 clutter_score=float(rng.uniform(0, 1)),
                 distance_score=float(rng.uniform(0, 1)))
            for _ in range(n)]


def make_logits_fn(model):
    """The last position's prompt logits in f32 for a list of token rows
    (left-padded with 0, as the JAX tool pads, with no pad mask) over the
    broadcast image features: (B, vocab) numpy."""
    import torch

    @torch.no_grad()
    def call(rows, feats):
        b = len(rows)
        t = max(len(r) for r in rows)
        ids = np.zeros((b, t), np.int64)
        for i, r in enumerate(rows):
            ids[i, t - len(r):] = r
        f = feats.expand(b, *feats.shape[1:])
        logits, _ = model(torch.as_tensor(ids).to(model.device),
                          image_features=f, logits_last_only=True)
        return logits[:, -1].to(torch.float32).cpu().numpy()

    return call


def run_mode(tag, model, frames, seed=0, pixel_values=None, trace=None):
    """One type's record over ``frames`` frames of ``make_candidates``
    (numpy seed ``seed``). The image is ``pixel_values`` ((1, S, S, 3)),
    or standard normal from a ``torch.Generator`` seeded with seed + 77;
    its features are computed once and shared by both batchings.
    ``trace``, a list, receives each frame's (batched scores, one-by-one
    scores)."""
    import torch
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.processor import build_prompt

    dev = model.device
    tok = FixedLenTok(model.cfg.vocab_size)
    batched = LlavaTorchScorer(model, tok, max_new_tokens=10,
                               decode_mode="steps")
    seq = LlavaTorchScorer(model, tok, max_new_tokens=10,
                           decode_mode="steps", max_batch=1)
    size = model.cfg.image_size
    if pixel_values is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + FEATURE_SEED_OFFSET)
        pixel_values = torch.randn((1, size, size, 3), generator=gen,
                                   device=dev)
    with torch.no_grad():
        feats = model.vision_project(
            torch.as_tensor(pixel_values, dtype=torch.float32).to(dev))

    rng = np.random.default_rng(seed)
    logits_fn = make_logits_fn(model)
    score_flips = total = 0
    max_rel_dlogit = 0.0
    n_img = model.cfg.num_patches
    for fi in range(frames):
        cands = make_candidates(rng)
        # the scorer's internals, so both batchings share one feature
        # tensor (score() would encode the image again)
        rows = [batched._encode(build_prompt(c, "pick"), n_img)
                for c in cands]
        with torch.no_grad():
            s_b = batched._score_batch(rows, feats)
            s_s = []
            for r in rows:
                s_s.extend(seq._score_batch([r], feats))
        if trace is not None:
            trace.append((list(s_b), list(s_s)))
        for a, b in zip(s_b, s_s):
            total += 1
            score_flips += a != b      # injective decode: flip <=> tokens
        lb = logits_fn(rows, feats)
        ls = np.concatenate([logits_fn([r], feats) for r in rows])
        denom = max(float(lb.std()), 1e-9)
        max_rel_dlogit = max(max_rel_dlogit,
                             float(np.abs(lb - ls).max()) / denom)
        print(f"  [{tag}] frame {fi + 1}/{frames}: flips so far "
              f"{score_flips}/{total}, max dlogit/std "
              f"{max_rel_dlogit:.3e}", flush=True)
    return dict(tag=tag, candidates=total, score_flips=score_flips,
                flip_rate=score_flips / max(total, 1),
                max_first_step_dlogit_over_std=max_rel_dlogit)


def main(argv=None):
    """Run the stability measurement; returns the list it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (CPU-safe)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--skip-bf16", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig)
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_state_device
    from tools.bench_vla_torch import build, build_quantized

    if args.tiny:
        cfg = LlavaTorchConfig(**TINY_LLAVA, dtype="bfloat16")
    else:
        cfg = LlavaTorchConfig(dtype="bfloat16", layers=args.layers,
                               hidden=args.hidden)
    results = []
    if args.skip_bf16 and args.int8:
        # the streamed int8 build: the whole bf16 tree never exists
        qmodel = build_quantized(cfg, device=dev)
        results.append(run_mode("int8", qmodel, args.frames))
        del qmodel
    else:
        model = build(cfg, device=dev)
        if not args.skip_bf16:
            results.append(run_mode("bf16", model, args.frames))
        if args.int8:
            box = [model.state_dict()]
            del model
            qmodel = LlavaTorch.from_state(
                dataclasses.replace(cfg, quantized=True),
                quantize_llava_state_device(box, bits=8))
            results.append(run_mode("int8", qmodel, args.frames))
            del qmodel
        else:
            del model
    free_memory(dev)
    stamp = device_stamp(dev)
    for rec in results:
        rec["device"] = stamp
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
