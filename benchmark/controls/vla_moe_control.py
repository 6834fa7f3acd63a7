#!/usr/bin/env python3
"""Readings that set the MoE rerank cell's ``token_gap_row_mean`` limit
and its draw's router and latent-norm settings, at the cell's own size:
for each seed the cell's model is drawn and its service serves
``check_reranks`` frames of the seed's cycle; each rerank's prompt-pass load (``moe_load``: the busiest
expert's routed pairs over the mean, the median over the layers) is
read, and its served tokens are judged against the plain reference (the
program's reading, also as the widest gap at each decode step). The
control, the reference with every matrix rounded to float8 e4m3 per
output channel, is judged at the same positions by the gap of the token
it puts first. A fault serves with the program broken as the cell's
faults break it: ``bias`` leaves the correction bias out of the choice,
``latent`` caches the latent before ``kv_a_layernorm``.

    python3 benchmark/controls/vla_moe_control.py --seeds 11,12,13 \\
        [--control-seeds 11] [--faults bias,latent] [--load-only] \\
        [--config '{"router_subspace": 0}']
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.core import spec  # noqa: E402
from benchmark.core.main import configure_torch  # noqa: E402
from benchmark.loops import serve  # noqa: E402
from benchmark.models import grasp_service as grasp  # noqa: E402
from benchmark.models import llava_moe_rerank as moe  # noqa: E402
from benchmark.reference import llava_moe_ref, llava_ref  # noqa: E402


@contextlib.contextmanager
def fault(name: str):
    """The program broken as the cell's fault ``name`` breaks it (nothing
    for "")."""
    from leafgrasp_tpu_torch.vla import mla
    from leafgrasp_tpu_torch.vla.moe import Router
    saved = []
    if name == "bias":
        def no_bias(self, x):
            with torch.no_grad():
                b = self.e_score_correction_bias.detach().clone()
                self.e_score_correction_bias.zero_()
                try:
                    return orig_router(self, x)
                finally:
                    self.e_score_correction_bias.copy_(b)
        orig_router = Router.forward
        saved.append((Router, "forward", orig_router))
        Router.forward = no_bias
    elif name == "latent":
        def raw(self, ckv, lat, k_rope):
            return orig_row(self, ckv, ckv[..., :lat.shape[-1]], k_rope)
        orig_row = mla.MLAttention._cache_row
        saved.append((mla.MLAttention, "_cache_row", orig_row))
        mla.MLAttention._cache_row = raw
    elif name:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def serve_reranks(cell, seed: int, dev, config: dict, overrides: dict):
    """(the rerank object, its judged records) of ``check_reranks`` frames
    of the seed's cycle."""
    from leafgrasp_tpu_torch import config as pconfig
    traffic = dict(cell.traffic, **overrides)
    fconf = moe.frame_config(config)
    rr = moe.Rerank(config, seed, dev, overrides, traffic)
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
    return rr, recs


def _spread(key: str, gaps) -> dict:
    """Of the judged positions' gaps (a (rows, steps) tensor a rerank):
    the worst row's mean (a row by its place in the batch, over the
    reranks: the cell's ``token_gap_row_mean``), the mean, the 90th
    percentile, the widest gap, and the share where the reference's best
    is the token itself."""
    rows: dict = {}
    for g in gaps:
        for r, x in enumerate(g.to(torch.float64)):
            rows.setdefault(r, []).append(x)
    g = torch.cat([x for v in rows.values() for x in v])
    return {f"{key}_token_gap_row_mean": max(float(torch.cat(v).mean())
                                            for v in rows.values()),
            f"{key}_token_gap": float(g.max()),
            f"{key}_token_gap_mean": float(g.mean()),
            f"{key}_token_gap_p90": float(torch.quantile(g, 0.9)),
            f"{key}_agree": float((g == 0).to(torch.float64).mean())}


@torch.no_grad()
def readings(cell, seed: int, dev, control=(), faults=(), config=None,
             load_only=False, overrides=None) -> dict:
    overrides = overrides or {}
    config = dict(cell.config, **(config or {}))
    out = {"seed": seed, **{k: config.get(k) for k in (
        "router_subspace", "router_calibration_frames",
        "kv_a_layernorm_gain_spread")}}
    for name in ("",) + tuple(faults):
        with fault(name):
            rr, recs = serve_reranks(cell, seed, dev, config, overrides)
        if not name:
            loads = [statistics.median(batch) for r in recs
                     for batch in r["last"].get("moe_load", ())]
            out["moe_load_median_over_layers"] = loads
            out["reranks"] = len(recs)
            if load_only:
                return out
        llava_ref._no_tf32()
        t0 = time.perf_counter()
        W = llava_moe_ref.Weights(rr.state)
        ctls = {q: llava_moe_ref.Weights(rr.state, q)
                for q in (control if not name else ())}
        prog, steps, ctl = [], None, {q: [] for q in ctls}
        for rec in recs:
            ref = llava_moe_ref.rerank_logits(W, rr.cfg, rec, dev)
            g = llava_ref.token_gaps(ref, rec["last"]["tokens"])
            prog.append(g)
            step = g.max(dim=0).values
            steps = step if steps is None else torch.maximum(steps, step)
            for q, Wq in ctls.items():
                ql = llava_moe_ref.rerank_logits(Wq, rr.cfg, rec, dev)
                ctl[q].append(llava_ref.control_gaps(ref, ql))
        key = f"fault_{name}" if name else "program"
        out.update(_spread(key, prog))
        if not name:
            out["program_gap_by_step"] = [round(float(v), 4) for v in steps]
            out["reference_s"] = time.perf_counter() - t0
        for q in ctls:
            out.update(_spread(f"control_{q}", ctl[q]))
        del rr, W, ctls
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="vla.moe.anyres.bf16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--faults", default="",
                    help="comma-separated: bias, latent")
    ap.add_argument("--config", default="{}",
                    help="JSON keys laid over the configuration's, as "
                    '\'{"router_subspace": 16, '
                    '"router_calibration_frames": 1}\'')
    ap.add_argument("--load-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    configure_torch(torch)
    cell = spec.resolve(args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    faults = tuple(f for f in args.faults.split(",") if f)
    for s in args.seeds.split(","):
        kinds = args.controls.split(",") if int(s) in ctl else []
        print(json.dumps(readings(cell, int(s), dev, kinds, faults,
                                  json.loads(args.config), args.load_only,
                                  json.loads(args.overrides))), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
