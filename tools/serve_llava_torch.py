#!/usr/bin/env python3
"""One-command LLaVA rerank serving from a checkpoint directory on the
PyTorch port: the counterpart of tools/serve_llava.py.

    python tools/serve_llava_torch.py /path/to/checkpoint \
        [--dtype bfloat16] [--quantize int8|int4] [--anyres] \
        [--lora-rank 8 --adapter adapter.npz] \
        [--framelog run.flog | --seed 8] [--device cpu]

Pipeline: ``vla.checkpoint_io.load_llava_checkpoint`` (config.json +
safetensors + tokenizer.model, no transformers) onto ``--device`` (CUDA
by default) -> ``LlavaTorchScorer`` (batched rerank; ``--anyres`` is the
v1.6 tiling) -> ``VLAProcessor`` -> ``HybridGraspSelector`` -> the
per-candidate scores and the fused choice for one frame, a frame of a
recorded framelog or a synthetic scene. The candidates come from the
port's own leaf stage (``make_frame_fn`` on the frame, then
``leaf_candidates``).

``main`` returns what ``--json`` prints: the JAX CLI's keys, and the
scorer's own record of the rerank (``vla_scores``, None when the scorer
raised and the choice fell back to geometry; ``generated_tokens`` for
each candidate; ``prefill_ms`` and ``decode_ms``, 0 off the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_scorer(args):
    from leafgrasp_tpu_torch.vla.checkpoint_io import load_llava_checkpoint
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer

    model, state, tok = load_llava_checkpoint(
        args.checkpoint, lora_rank=args.lora_rank, dtype=args.dtype,
        quantize=args.quantize != "none",
        quant_bits={"int8": 8, "int4": 4}.get(args.quantize, 8),
        quant_group=args.quant_group, device=args.device)
    if args.adapter:
        from leafgrasp_tpu_torch.vla.convert import flax_to_torch_llava
        adapter = flax_to_torch_llava(dict(np.load(
            os.path.expanduser(args.adapter))))
        model.load_state_dict({k: v.to(state[k].device, state[k].dtype)
                               for k, v in adapter.items()}, strict=False)
    impl = args.prefill_impl
    if impl == "auto":
        # the flash prefill for the long anyres prompts, chunked for the
        # single-tile ones, as the JAX CLI picks
        impl = "flash" if args.anyres else "chunked"
    model.set_prefill_attn(impl)
    return LlavaTorchScorer(
        model, tok, max_new_tokens=args.max_new_tokens,
        max_batch=args.max_batch or None, decode_mode=args.decode_mode,
        decode_weight_layout=args.weight_layout, anyres=args.anyres)


def load_frame(args, cfg):
    """(mask, depth, rgb) from a framelog or a synthetic scene."""
    if args.framelog:
        from leafgrasp_tpu_torch.io.framelog import FrameLogReader
        with FrameLogReader(args.framelog) as rd:
            if len(rd) == 0:
                raise SystemExit(f"framelog {args.framelog} is empty")
            mask, depth, _ = rd.frame(args.frame_index)
            mask, depth = np.array(mask), np.array(depth)
    else:
        from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
        margin = min(120, cfg.frame.height // 6, cfg.frame.width // 6)
        mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                      num_leaves=6, seed=args.seed,
                                      margin=margin)
    # a grey stand-in RGB when no camera image is recorded: the depth map
    # rendered to [0, 255] (the scorer needs only an image)
    d = depth.astype(np.float32)
    span = d.max() - d.min()
    rgb = np.zeros(d.shape + (3,), np.uint8) if span <= 0 else (
        np.repeat(((d - d.min()) / span * 255).astype(np.uint8)[..., None],
                  3, axis=-1))
    return mask, depth, rgb


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="HF-layout checkpoint dir "
                    "(config.json + safetensors + tokenizer.model)")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="type of the stored weights (the compute type "
                    "stays the config's, as in the JAX CLI)")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4"],
                    help="weight-only quantized serving (vla/quant.py)")
    ap.add_argument("--quant-group", type=int, default=128)
    ap.add_argument("--anyres", action="store_true",
                    help="LLaVA-NeXT (v1.6) grid-pinpoint tiling")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--adapter", default="",
                    help="LoRA adapter .npz (the JAX package's save "
                    "format, vla/lora.py)")
    ap.add_argument("--prefill-impl", default="auto",
                    choices=["auto", "chunked", "flash"],
                    help="prompt-pass attention: 'flash' is the CUDA "
                    "kernel (its plain version on the CPU), 'chunked' the "
                    "query-chunked einsum; 'auto' picks flash for --anyres")
    ap.add_argument("--decode-mode", default="steps",
                    choices=["scan", "steps"])
    ap.add_argument("--weight-layout", default="default",
                    choices=["default", "auto"],
                    help="'auto' exists only in the JAX CLI and raises")
    ap.add_argument("--max-new-tokens", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=0)
    ap.add_argument("--framelog", default="",
                    help="recorded native framelog to serve from")
    ap.add_argument("--frame-index", type=int, default=0)
    ap.add_argument("--seed", type=int, default=8,
                    help="synthetic scene seed when no framelog is given")
    ap.add_argument("--candidates", type=int, default=5)
    ap.add_argument("--frame-size", nargs=2, type=int, default=None,
                    metavar=("H", "W"),
                    help="frame dims for the synthetic scene and the leaf "
                    "stage (default: production 1080 1440)")
    ap.add_argument("--instruction",
                    default="Select the best leaf for grasping")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON line")
    return ap.parse_args(argv)


def frame_config(frame_size):
    """The pipeline config, resized as the JAX CLI resizes it."""
    from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG, CameraConfig,
                                            FrameConfig, LeafSelectionConfig)
    if not frame_size:
        return DEFAULT_CONFIG
    h, w = frame_size
    return dataclasses.replace(
        DEFAULT_CONFIG, frame=FrameConfig(height=h, width=w, max_leaves=8),
        camera=CameraConfig(fx=2.0 * w, cx=w / 2.0, cy=h / 2.0),
        leaf=LeafSelectionConfig(min_leaf_area=max(64, h * w // 200)))


def main(argv=None):
    args = parse_args(argv)
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.pipeline.ingest import leaf_candidates
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
    from leafgrasp_tpu_torch.vla.processor import VLAProcessor

    cfg = frame_config(args.frame_size)
    mask, depth, rgb = load_frame(args, cfg)

    t0 = time.monotonic()
    scorer = build_scorer(args)
    t_load = time.monotonic() - t0
    print(f"loaded {args.checkpoint} dtype={args.dtype} "
          f"quantize={args.quantize} anyres={args.anyres} on "
          f"{scorer.model.device} in {t_load:.1f}s", file=sys.stderr)

    # the leaf stage on the same device -> candidates
    fn = make_frame_fn(cfg, with_cnn=False, device=scorer.model.device)
    res = fetch_to_host(fn(mask.astype(np.int32), depth.astype(np.float32),
                           np.float32(cfg.camera.cx),
                           np.float32(cfg.camera.cy),
                           np.float32(cfg.camera.fx)))
    cands = leaf_candidates(res.leaf_selection,
                            max_candidates=args.candidates)
    if not cands:
        raise SystemExit("no area-valid leaf candidates in this frame")

    t1 = time.monotonic()
    selector = HybridGraspSelector(VLAProcessor(scorer))
    best = selector.select_grasp_point(rgb, cands, args.instruction)
    t_rerank = time.monotonic() - t1

    # the selector falls back to geometric-only scores when the scorer
    # raises; the scorer's own record says whether its rerank finished
    # (``scores`` is set only when ``score`` returns)
    last = scorer.last
    result = dict(candidates=cands, best=best, rerank_s=round(t_rerank, 3),
                  load_s=round(t_load, 1), vla_scores=last.get("scores"),
                  generated_tokens=[len(r) for r in last.get("tokens", [])],
                  prefill_ms=last.get("prefill_ms"),
                  decode_ms=last.get("decode_ms"))
    if args.json:
        print(json.dumps(result))
        return result
    print(f"\n{len(cands)} candidates (leaf stage), "
          f"rerank {t_rerank * 1e3:.0f} ms:")
    for c in cands:
        tag = " <= selected" if best and c["leaf_id"] == best.get(
            "leaf_id") else ""
        print(f"  leaf {c['leaf_id']:2d} @({c['x']:7.1f},{c['y']:7.1f}) "
              f"geo={c['geometric_score']:.3f}{tag}")
    print(f"strategy={best['strategy']} "
          f"confidence={best['vla_confidence']:.3f}")
    if result["vla_scores"] is None:
        print("the VLA rerank failed: the choice is geometric-only",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
