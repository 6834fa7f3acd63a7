#!/usr/bin/env python3
"""VLA serving benchmark of the PyTorch port: LLaVA-1.6-Mistral-7B-width
rerank latency on one GPU, the counterpart of tools/bench_vla.py.

It times the reference's VLA hot path (a greedy 10-token generate per
candidate, five candidates a frame) with random bf16 weights: one
candidate after another, the +30-token decode rate, and the five
candidates in one left-padded batch (the serving scorer's path).

``build`` draws every parameter directly on the device in bf16 from a
seeded ``torch.Generator`` (no f32 tree ever exists); ``build_quantized``
draws and quantizes to int8 weight by weight, so the bf16 tree never
exists whole. The other VLA tools import both.

Prints bench_vla.py's text lines, then one JSON line with their numbers
and ``device`` (the card's name and power limit). A failure raises.

    python tools/bench_vla_torch.py [--layers 32]
    python tools/bench_vla_torch.py --tiny --device cpu
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tools._torch_bench import (TINY_LLAVA, device_stamp,  # noqa: E402
                                sync, timed)
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402

NEWLINE_SEED = 7       # the JAX tools' image_newline draw (numpy seed 7)


def _newline_(model) -> None:
    """The anyres tile separator, which real v1.6 checkpoints carry:
    0.02 * standard normal from numpy seed 7, as the JAX tools set it."""
    import torch
    if model.image_newline is not None:
        with torch.no_grad():
            model.image_newline.copy_(torch.as_tensor(
                0.02 * np.random.default_rng(NEWLINE_SEED).standard_normal(
                    model.cfg.hidden), dtype=model.image_newline.dtype))


def build(cfg, seed: int = 0, device=None):
    """``LlavaTorch`` at ``cfg``'s widths with every parameter drawn on
    ``device`` (None means CUDA) in bf16 from a ``torch.Generator``
    seeded with ``seed``: 0.02 * randn, the norm gains 1 + 0.02 * randn
    (``init_random_``)."""
    import torch
    from leafgrasp_tpu_torch.utils.device import resolve_device
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch, init_random_
    dev = resolve_device(device)
    model = LlavaTorch(dataclasses.replace(cfg, quantized=False),
                       device=dev, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init_random_(model, gen, std=0.02)
    _newline_(model)
    return model


def build_quantized(cfg, seed: int = 0, device=None):
    """The int8-serving model of ``cfg`` without the whole bf16 tree:
    the parameters are drawn as ``build`` draws them, one at a time, and
    each language-model projection is quantized (``quantize_kernel``,
    per channel) as soon as it is drawn, so the device holds the int8
    tree and one bf16 weight at most."""
    import torch
    from leafgrasp_tpu_torch.utils.device import resolve_device
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     iter_random_llava_state)
    from leafgrasp_tpu_torch.vla.quant import (is_quantized_weight,
                                               quantize_kernel)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = {}
    for key, t in iter_random_llava_state(
            dataclasses.replace(cfg, quantized=False), gen, dev,
            torch.bfloat16):
        if is_quantized_weight(key):
            q, s = quantize_kernel(t.T, 8)
            del t
            prefix = key[:-len("weight")]
            state[prefix + "kernel_q"] = q
            state[prefix + "kernel_scale"] = s
        else:
            state[key] = t
    model = LlavaTorch.from_state(
        dataclasses.replace(cfg, quantized=True, quant_bits=8), state)
    _newline_(model)
    return model


def main(argv=None):
    """Run the benchmark; returns the JSON record it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers (a depth cut; 32 is the 7B model)")
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX tools' tiny widths (CPU-safe)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    import torch
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorchConfig,
                                                     greedy_generate_llava)
    n_text = 60           # the reference prompt is about 100 tokens
    n_new = 10            # llava_processor.py:78 max_new_tokens=10
    n_candidates = 5

    if args.tiny:
        cfg = LlavaTorchConfig(**{**TINY_LLAVA, "dtype": "bfloat16"})
        dims = "tiny"
    else:
        cfg = LlavaTorchConfig(dtype="bfloat16", layers=args.layers)
        dims = "7B" if args.layers == 32 else \
            f"7B widths, {args.layers} layers"
    model = build(cfg, device=dev)
    n_img = cfg.num_patches       # 576 for 336/14 (CLS dropped)
    ids = np.full((1, n_text + n_img), 7, np.int64)
    ids[0, 2:2 + n_img] = cfg.image_token_index
    ids = torch.as_tensor(ids).to(dev)
    px = torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=dev)

    def gen(new_tokens=n_new):
        return greedy_generate_llava(model, ids, pixel_values=px,
                                     max_new_tokens=new_tokens)

    compile_s = timed(gen, dev)
    print(f"{dims} bf16: first run in {compile_s:.1f}s", flush=True)

    def five():
        for _ in range(n_candidates):
            gen()

    best = min(timed(five, dev) for _ in range(3))
    per_cand = best / n_candidates
    seq = n_text + n_img
    print(f"prefill {seq} tok + decode {n_new} tok: "
          f"{per_cand * 1e3:.0f} ms/candidate", flush=True)
    print(f"5-candidate VLA rerank: {best * 1e3:.0f} ms/frame "
          f"({1.0 / best:.2f} frames/s)", flush=True)
    # decode-only rate: re-time with a longer decode to isolate it
    timed(lambda: gen(n_new + 30), dev)
    longer = timed(lambda: gen(n_new + 30), dev)
    tok_s = 30.0 / max(longer - per_cand, 1e-9)
    print(f"decode rate ~{tok_s:.1f} tok/s (from +30-token delta)",
          flush=True)

    # batched rerank: all candidates in ONE left-padded generate (the
    # LlavaTorchScorer serving path)
    idsb = ids.expand(n_candidates, -1).contiguous()
    pad = torch.zeros((n_candidates,), dtype=torch.int32, device=dev)
    pxb = torch.zeros((n_candidates, cfg.image_size, cfg.image_size, 3),
                      device=dev)

    def genb():
        return greedy_generate_llava(model, idsb, pixel_values=pxb,
                                     max_new_tokens=n_new, pad_lens=pad,
                                     decode_mode="steps")

    timed(genb, dev)
    bestb = min(timed(genb, dev) for _ in range(3))
    print(f"BATCHED 5-candidate rerank: {bestb * 1e3:.0f} ms/frame "
          f"({1.0 / bestb:.2f} frames/s, {best / bestb:.1f}x vs "
          f"sequential)", flush=True)
    sync(dev)
    rec = {"metric": "vla_rerank_latency", "dims": dims,
           "layers": cfg.layers, "prompt_tokens": seq, "new_tokens": n_new,
           "candidates": n_candidates,
           "first_run_s": round(compile_s, 3),
           "ms_per_candidate": round(per_cand * 1e3, 3),
           "sequential_rerank_ms": round(best * 1e3, 3),
           "decode_tok_per_s": round(tok_s, 3),
           "batched_rerank_ms": round(bestb * 1e3, 3),
           "batched_speedup": round(best / bestb, 3),
           "device": device_stamp(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
