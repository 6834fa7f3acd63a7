#!/usr/bin/env python3
"""Anyres (LLaVA-NeXT v1.6) rerank latency at 7B widths on one GPU, on
the PyTorch port: the counterpart of tools/bench_vla_anyres.py.

For a 1080x1440 frame the 672x672 pinpoint wins: 4 spatial tiles plus
the base resize pass the tower, and the packed prompt holds about 2.3k
image tokens (576 single-tile). This times ``LlavaTorchScorer(anyres=
True)`` end to end (tiling on the device, tower, packing, batched
prefill, 10-token decode) with random weights at the 7B widths:

* ``--quantize int8``: the serving configuration (``build_quantized``);
  bf16 by default (the 80 GB card holds the B=5 anyres prefill beside
  the 14.1 GB of weights);
* ``--stages``: the split into tile preparation (on the device here, on
  the host in the JAX package; the key keeps its name), encode,
  prefill and decode;
* ``--flash-ab``: the flash prefill (``prefill_attn_impl="flash"``, the
  hand-written CUDA kernel of kernels/csrc/flash_prefill.cu) against the
  default chunked route in one process, best of three interleaved, and
  whether the greedy tokens agree. The "flash+scan" variant runs too;
  here it takes the same decode route, and a failure of it raises.

Prints the JAX tool's lines and its JSON record, plus ``device`` (the
card's name and power limit).

    python tools/bench_vla_anyres_torch.py [--quantize int8] [--frames 3]
        [--max-batch 5] [--stages] [--flash-ab]
    python tools/bench_vla_anyres_torch.py --tiny --device cpu
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tools._torch_bench import (TINY_LLAVA, TINY_PINPOINTS,  # noqa: E402
                                V16_PINPOINTS, AnyresTok, device_stamp,
                                timed)
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402

INSTRUCTION = "pick the best leaf"


def main(argv=None):
    """Run the benchmark; returns the JSON record it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quantize", choices=["none", "int8"], default="none")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--candidates", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers at the 7B widths (a depth cut)")
    ap.add_argument("--stages", action="store_true",
                    help="split the rerank into tile prep / encode / "
                         "prefill / decode")
    ap.add_argument("--flash-ab", action="store_true",
                    help="A/B the flash prefill against the chunked "
                         "prefill in one process and compare their "
                         "greedy tokens")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.vla.llava_next import preprocess_anyres
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    from tools.bench_vla_torch import build, build_quantized

    if args.tiny:
        cfg = LlavaTorchConfig(**TINY_LLAVA, dtype="bfloat16",
                               image_grid_pinpoints=TINY_PINPOINTS)
    else:
        cfg = LlavaTorchConfig(dtype="bfloat16", layers=args.layers,
                               image_grid_pinpoints=V16_PINPOINTS)
    if args.quantize == "int8":
        model = build_quantized(cfg, device=dev)
    else:
        model = build(cfg, device=dev)

    def make_scorer(decode_mode="steps"):
        return LlavaTorchScorer(model, AnyresTok(cfg.vocab_size),
                                max_new_tokens=10, decode_mode=decode_mode,
                                max_batch=args.max_batch, anyres=True)

    scorer = make_scorer()
    rng = np.random.default_rng(0)
    h, w = (90, 120) if args.tiny else (1080, 1440)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    feats, n_img = scorer._encode_image(img)
    print(f"anyres: {feats.shape[1]} packed image tokens "
          f"(single-tile would be {cfg.num_patches})", flush=True)
    cands = [dict(x=int(rng.integers(w)), y=int(rng.integers(h)),
                  geometric_score=float(rng.uniform()))
             for _ in range(args.candidates)]

    def rerank(sc=scorer, impl="chunked"):
        model.set_prefill_attn(impl)
        return sc.score(img, cands, INSTRUCTION)

    first_s = timed(rerank, dev)
    print(f"first anyres rerank in {first_s:.1f}s", flush=True)

    best = float("inf")
    for fi in range(args.frames):
        dt = timed(rerank, dev)
        best = min(best, dt)
        print(f"frame {fi + 1}: {dt * 1e3:.0f} ms", flush=True)

    stages = None
    if args.stages:
        def best_of(fn, n=3):
            return min(timed(fn, dev) for _ in range(n)) * 1e3

        # tile preparation: the resizes, tiling and CLIP normalization
        # (on the device here)
        t_prep = best_of(lambda: preprocess_anyres(
            img, cfg.image_grid_pinpoints, cfg, device=model.device))
        # encode (tower over the tiles and packing), the preparation
        # included -> subtracted below
        t_enc_tot = best_of(lambda: scorer._encode_image(img))
        # the prompt pass only: max_new_tokens=1 runs no decode step
        scorer.max_new_tokens = 1
        rerank()
        t_pref_tot = best_of(rerank)
        scorer.max_new_tokens = 10
        t_full = best_of(rerank)
        stages = dict(
            host_tile_prep_ms=round(t_prep, 1),
            device_encode_ms=round(t_enc_tot - t_prep, 1),
            prefill_ms=round(t_pref_tot - t_enc_tot, 1),
            decode_9_steps_ms=round(t_full - t_pref_tot, 1),
            full_rerank_ms=round(t_full, 1))
        print("stage split:", json.dumps(stages), flush=True)

    flash = None
    if args.flash_ab:
        # one model, its prompt pass switched between the routes
        scorer_fs = make_scorer(decode_mode="scan")
        print(f"flash prefill first rerank in "
              f"{timed(lambda: rerank(impl='flash'), dev):.1f}s", flush=True)
        print(f"flash+scan first rerank in "
              f"{timed(lambda: rerank(scorer_fs, 'flash'), dev):.1f}s",
              flush=True)

        # interleaved A/B, best-of
        best_f = best_c = best_s = float("inf")
        out = {}
        for _ in range(3):
            best_f = min(best_f, timed(
                lambda: out.__setitem__("f", rerank(impl="flash")), dev))
            best_c = min(best_c, timed(
                lambda: out.__setitem__("c", rerank()), dev))
            best_s = min(best_s, timed(
                lambda: out.__setitem__("s", rerank(scorer_fs, "flash")),
                dev))
        sf, sc, sfs = out["f"], out["c"], out["s"]
        model.set_prefill_attn("chunked")
        flash = dict(
            flash_rerank_ms=round(best_f * 1e3, 1),
            chunked_rerank_ms=round(best_c * 1e3, 1),
            speedup=round(best_c / best_f, 3),
            scores_match=bool(sf == sc),
            flash_scan_rerank_ms=round(best_s * 1e3, 1),
            scan_scores_match=bool(sfs == sf))
        print("flash A/B:", json.dumps(flash), flush=True)

    rec = dict(
        mode=f"anyres_{'int8' if args.quantize == 'int8' else 'bf16'}",
        packed_image_tokens=int(n_img),
        candidates=args.candidates, max_batch=args.max_batch,
        best_rerank_ms=round(best * 1e3, 1),
        stages=stages, flash_ab=flash, device=device_stamp(dev))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
