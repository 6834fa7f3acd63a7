#!/usr/bin/env python3
"""End-to-end VLA-enhanced service on one GPU, on the PyTorch port: the
counterpart of tools/bench_vla_service.py.

Leaf selection, candidate rerank and grasp selection run per live frame
as ONE GraspService:

* ``GraspService(hybrid_selector=HybridGraspSelector(VLAProcessor(
  LlavaTorchScorer)))`` with random weights at the 7B widths,
  ``--quantize int8`` (the default, ``build_quantized``) or bf16;
  ``--anyres`` serves the v1.6 tiling path (about 2.3k image tokens a
  frame) through the flash prefill (the CUDA kernel of
  kernels/csrc/flash_prefill.cu); single-tile serving takes the chunked
  prefill, as the JAX tool;
* frames enter through on_mask / on_depth / on_rgb and process_pending
  (the frame bus's pairing, the rate gate forced off);
* it measures frames/s, the stage split of the serial service
  (select_grasp / fetch / vla_rerank / vla_reselect / finalize from its
  StageTimer) and the card's memory beside the weights;
* A/B in one process: serial (pipeline_depth=0) against overlapped
  (pipeline_depth=1), alternating batches, best of three;
* degradation: the scorer's backend raises (the service must still
  publish a VLA choice at the uniform scores), then the whole selector
  raises (the geometric result must publish). Both are correctness
  checks: if either fails the tool exits non-zero and writes nothing.

The record (the JAX tool's keys, plus ``device``: the card's name and
power limit) is printed and, for a full-width run, written to
``artifacts/torch/vla_service_bench.json`` (``--out`` to choose; the
anyres record goes to ``artifacts/torch/vla_service_bench_anyres.json``
through ``--out``) with ``backend``, ``recorded_unix`` and ``git_rev``.
bench_torch.py reads the default file back. The JAX package's
``artifacts/vla_service_bench*.json`` are never written.

    python tools/bench_vla_service_torch.py [--frames 10]
        [--quantize int8|none] [--anyres] [--json] [--out PATH]
    python tools/bench_vla_service_torch.py --tiny --device cpu \\
        --frame-size 270 360 --frames 2
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tools._torch_bench import (TINY_LLAVA, TINY_PINPOINTS,  # noqa: E402
                                TORCH_ARTIFACTS, V16_PINPOINTS, FixedLenTok,
                                device_mem_gb, device_stamp, git_rev, sync)
from tools._torch_eval import (add_device_arg, setup_device,  # noqa: E402
                               write_json)

DEFAULT_OUT = os.path.join(TORCH_ARTIFACTS, "vla_service_bench.json")
# (num_leaves, seed, margin): bench.py's families at 1080 rows
FAMILIES = ((6, 8, 120), (12, 3, 60), (3, 5, 260))
FRAME_H = 1080


class _Boom:
    """A scorer backend that raises (degradation 1)."""

    def score(self, *a, **k):
        raise RuntimeError("backend failure injection")


class _Raiser:
    """A selector that raises, as on a device OOM (degradation 2)."""

    def select_grasp_point(self, *a, **k):
        raise RuntimeError("selector failure injection (OOM)")


def llava_config(tiny: bool, anyres: bool, layers: int = 32):
    """The tool's LlavaTorchConfig: the JAX tool's tiny or 7B widths
    (``layers`` deep) in bf16; anyres serves the v1.6 grid through the
    flash prefill."""
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    impl = "flash" if anyres else "chunked"
    if tiny:
        return LlavaTorchConfig(
            **TINY_LLAVA, dtype="bfloat16", prefill_attn_impl=impl,
            image_grid_pinpoints=TINY_PINPOINTS if anyres else None)
    return LlavaTorchConfig(
        dtype="bfloat16", prefill_attn_impl=impl, layers=layers,
        image_grid_pinpoints=V16_PINPOINTS if anyres else None)


def service_config(height: int, width: int):
    """DEFAULT_CONFIG (union isolation) at ``height`` x ``width``."""
    import dataclasses
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    return DEFAULT_CONFIG.replace(frame=dataclasses.replace(
        DEFAULT_CONFIG.frame, height=height, width=width))


def record_path(out, tiny: bool):
    """Where the record is written: ``--out``, else DEFAULT_OUT for a
    full-width run, else nowhere."""
    return out if out else (None if tiny else DEFAULT_OUT)


def main(argv=None):
    """Run the service benchmark; returns its record. Exits non-zero
    (SystemExit) when a degradation check fails."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--quantize", choices=["none", "int8"], default="int8")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny LLaVA widths (CPU-safe)")
    ap.add_argument("--anyres", action="store_true",
                    help="serve the v1.6 anyres tiling path through the "
                         "flash prefill")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers at the 7B widths (a depth cut)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the record to this JSON file "
                         "(default for full-width runs: "
                         "artifacts/torch/vla_service_bench.json)")
    ap.add_argument("--frame-size", type=int, nargs=2, default=(1080, 1440),
                    metavar=("H", "W"),
                    help="camera frame size (default the production "
                         "1080 x 1440)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    import torch
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.utils.profiler import StageTimer
    from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.processor import VLAProcessor
    from tools.bench_vla_torch import build, build_quantized

    t0 = time.monotonic()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg_l = llava_config(args.tiny, args.anyres, args.layers)
    if args.quantize == "int8":
        model = build_quantized(cfg_l, device=dev)
    else:
        model = build(cfg_l, device=dev)
    scorer = LlavaTorchScorer(model, FixedLenTok(cfg_l.vocab_size),
                              max_new_tokens=10, decode_mode="steps",
                              anyres=args.anyres)
    sync(dev)
    t_build = time.monotonic() - t0
    mem_weights, mem_method = device_mem_gb(dev)

    h, w = args.frame_size
    cfg = service_config(h, w)
    cnn, _ = init_grasp_cnn(0, cfg.model)
    cnn = cnn.to(dev).eval()
    # per-service sinks so the published counts keep the A/B modes apart;
    # the recorded stages cover the SERIAL service only
    published = {"serial": [], "overlap": []}

    def make_svc(depth_n, sink):
        return GraspService(cfg, cnn=cnn,
                            hybrid_selector=HybridGraspSelector(
                                VLAProcessor(scorer)),
                            publish=published[sink].append,
                            min_interval_s=0.0, pipeline_depth=depth_n,
                            device=dev)

    svc = make_svc(0, "serial")
    svc_over = make_svc(1, "overlap")

    # mixed families (bench.py), margins scaled to the frame's rows
    scenes = [make_leaf_scene(h, w, num_leaves=n, seed=s,
                              margin=m * h // FRAME_H)
              for n, s, m in FAMILIES]
    rgb = (np.random.default_rng(0).uniform(0, 255, (h, w, 3))
           .astype(np.uint8))
    svc.on_rgb(rgb)
    svc_over.on_rgb(rgb)

    def feed(s, i):
        mask, depth = scenes[i % len(scenes)]
        s.on_mask(np.roll(mask, 3 * i, axis=1), stamp_us=i)
        s.on_depth(np.roll(depth, 3 * i, axis=1), stamp_us=i)

    # warm-up: allocator, cuDNN plans, the first rerank
    feed(svc, 0)
    out = svc.process_pending(force=True)
    assert out is not None and out["found"], "warm-up frame failed"
    print(f"warmup ok in {time.monotonic() - t0:.0f}s "
          f"(build {t_build:.0f}s); vla={out['vla'] is not None}",
          flush=True)
    feed(svc_over, 0)
    svc_over.process_pending(force=True)
    svc_over.flush()
    svc.timer = StageTimer()                  # drop the warm-up's stages

    def run_batch(s, n, i0):
        """Wall time for n frames through service s (drained)."""
        n_vla = 0
        t = time.monotonic()
        for i in range(i0, i0 + n):
            feed(s, i)
            out = s.process_pending(force=True)
            if out is not None:
                assert out["found"]
                n_vla += out["vla"] is not None
        for out in s.flush():
            assert out["found"]
            n_vla += out["vla"] is not None
        sync(dev)
        return time.monotonic() - t, n_vla

    # interleaved A/B batches, best of three per mode; the stage timer
    # resets after rep 0, so the stage means are steady-state
    half = max(2, args.frames // 2)
    walls = {"serial": [], "overlap": []}
    n_vla = 0
    for rep in range(3):
        wall, v = run_batch(svc, half, 1 + 2 * rep * half)
        walls["serial"].append(wall / half)
        n_vla += v
        wall, v = run_batch(svc_over, half, 1 + (2 * rep + 1) * half)
        walls["overlap"].append(wall / half)
        if rep == 0:
            svc.timer = StageTimer()
        print(f"rep {rep}: serial {walls['serial'][-1] * 1e3:.0f} "
              f"ms/frame, overlap {walls['overlap'][-1] * 1e3:.0f}",
              flush=True)
    best_serial = min(walls["serial"])
    best_over = min(walls["overlap"])
    mem_peak = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2) \
        if dev.type == "cuda" else None
    stages = {k: dict(mean_ms=round(v["mean_ms"], 1), count=v["count"])
              for k, v in svc.timer.summary().items()}

    # degradation 1: the backend raises -> VLAProcessor returns uniform
    # 0.5 scores -> a choice still comes back at the low confidence
    svc.hybrid_selector.processor.backend = _Boom()
    feed(svc, 10 * args.frames + 1)
    out1 = svc.process_pending(force=True)
    inner_ok = bool(out1 is not None and out1["found"]
                    and out1["vla"] is not None)
    inner_strategy = out1["vla"]["strategy"] if inner_ok else None

    # degradation 2: the whole selector raises -> the service catches it
    # and the geometric result publishes with vla=None
    svc.hybrid_selector = _Raiser()
    feed(svc, 10 * args.frames + 2)
    out2 = svc.process_pending(force=True)
    degraded_ok = bool(out2 is not None and out2["found"]
                       and out2["message"] and out2["vla"] is None)

    rec = dict(
        metric="vla_enhanced_service_frames_per_sec",
        frames=args.frames, value=round(1.0 / best_serial, 3),
        ms_per_frame=round(best_serial * 1e3, 1),
        overlap_fps=round(1.0 / best_over, 3),
        overlap_ms_per_frame=round(best_over * 1e3, 1),
        overlap_speedup=round(best_serial / best_over, 3),
        ab_ms_per_frame={k: [round(x * 1e3, 1) for x in v]
                         for k, v in walls.items()},
        vla_reranked_frames=n_vla,
        quantize=args.quantize,
        dims="tiny" if args.tiny else "7B" if args.layers == 32
        else f"7B widths, {args.layers} layers",
        anyres=args.anyres,
        stages=stages,
        stages_note="stages cover the serial service only",
        published={k: len(v) for k, v in published.items()},
        hbm_gb_after_weights=mem_weights, hbm_gb_peak_seen=mem_peak,
        hbm_method=mem_method,
        inner_degradation_uniform_scores_ok=inner_ok,
        inner_degradation_strategy=inner_strategy,
        degraded_geometric_fallback_ok=degraded_ok,
        device=device_stamp(dev))
    print(json.dumps(rec, indent=None if args.json else 2), flush=True)
    if not (inner_ok and degraded_ok):
        raise SystemExit(f"degradation check failed: inner {inner_ok}, "
                         f"geometric fallback {degraded_ok}")

    out_path = record_path(args.out, args.tiny)
    if out_path:
        rec["recorded_unix"] = int(time.time())
        rec["backend"] = dev.type
        rec["git_rev"] = git_rev()
        write_json(out_path, rec)
        print(f"wrote {out_path}", file=sys.stderr)
    return rec


if __name__ == "__main__":
    main()
