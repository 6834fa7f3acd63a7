#!/usr/bin/env python3
"""Readings that set the VLA cell's ``token_gap`` limit, at the cell's
own size: for each seed the cell's model is drawn and its service
serves ``check_reranks`` frames of the seed's cycle; each rerank's
served tokens are judged against the plain reference (the program's
reading), and the control, the reference with every matrix rounded to
float8 e4m3 per output channel (``--controls int8`` adds the int8
rounding), is judged at the same positions by the gap of the token it
puts first (the control's reading).

    python3 benchmark/controls/vla_control.py --seeds 11,12,13 \\
        [--control-seeds 11,12,13]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.core import spec  # noqa: E402
from benchmark.core.main import configure_torch  # noqa: E402
from benchmark.loops import serve  # noqa: E402
from benchmark.models import grasp_service as grasp  # noqa: E402
from benchmark.models import llava_rerank as llava  # noqa: E402
from benchmark.reference import llava_ref  # noqa: E402


@torch.no_grad()
def readings(cell, seed: int, dev, control=(), overrides=None) -> dict:
    from leafgrasp_tpu_torch import config as pconfig
    overrides = overrides or {}
    traffic = dict(cell.traffic, **overrides)
    fconf = llava.frame_config(cell.config)
    rr = llava.Rerank(cell.config, seed, dev, overrides, traffic)
    cfg = grasp.pipeline_config(fconf, pconfig, overrides)
    cnn = grasp.program_cnn(cfg, grasp.cnn_state(cfg, seed, dev), dev)
    service = serve.build_service(cfg, cnn, rr.selector, dev, fconf)
    frames = serve.frame_cycle(traffic, seed, cfg.frame.height,
                               cfg.frame.width, dev, True)
    recs, i = [], 0
    while len(recs) < rr.check_reranks and i < len(frames):
        mask, depth, rgb = frames[i]
        service.on_rgb(rgb)
        service.on_mask(mask, i + 1)
        service.on_depth(depth, i + 1)
        service.process_pending(force=True)
        rec = rr.take()
        if rec["ran"] and not rec["failed"]:
            recs.append(rec)
        i += 1
    service.bus.close()
    rr.release()
    llava_ref._no_tf32()
    t0 = time.perf_counter()
    W = llava_ref.Weights(rr.state)
    ctls = {q: llava_ref.Weights(rr.state, q) for q in control}
    prog, ctl, n = 0.0, {q: 0.0 for q in control}, 0
    for rec in recs:
        ref = llava_ref.rerank_logits(W, rr.cfg, rec, dev)
        g = llava_ref.token_gaps(ref, rec["last"]["tokens"])
        prog, n = max(prog, float(g.max())), n + g.numel()
        for q, Wq in ctls.items():
            ql = llava_ref.rerank_logits(Wq, rr.cfg, rec, dev)
            ctl[q] = max(ctl[q], float(llava_ref.control_gaps(ref, ql)
                                       .max()))
    out = {"seed": seed, "reranks": len(recs), "tokens": n,
           "program_token_gap": prog,
           "reference_s": time.perf_counter() - t0}
    for q in control:
        out[f"control_{q}_token_gap"] = ctl[q]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="vla.anyres.bf16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="fp8",
                    help="comma-separated: fp8 (the control), int8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    configure_torch(torch)
    cell = spec.resolve(args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        kinds = args.controls.split(",") if int(s) in ctl else []
        print(json.dumps(readings(cell, int(s), dev, kinds,
                                  json.loads(args.overrides))), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
