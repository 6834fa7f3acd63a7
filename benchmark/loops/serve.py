"""The closed-loop grasp service: one client (the robot's grasp loop)
hands a frame to ``GraspService`` and waits for its published result
before it sends the next.

A frame's time runs from ``on_rgb`` / ``on_mask`` / ``on_depth`` to the
return of ``process_pending(force=True)`` with the published result.
The window ends with the first frame to finish after ``--seconds``; its
length is the time from its start to that frame's end, so a rate takes
every frame of the window over all of its time.

The mix's file (``traffic/<name>.json``, ``"loop": "serve"``) sets the
frames: ``pool_scenes`` scenes drawn on the card from the seed
(``hard_share`` of them hard), ``leaves`` and ``margin_px`` ranges,
``cycle_frames`` frames, the pool scenes in turn, each rolled by up to
``roll_px``, sent in a seeded order; ``rgb`` adds a camera image a frame (the
rerank's input);
``warmup_frames`` frames run before the window; with ``--trace 1``,
``trace_frames`` more frames run after it under the profiler (the
device readings; the host-clock readings come from the window, which the
profiler would slow); ``check_frames`` frames of the window, drawn from
the seed, are judged against the reference after it.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from benchmark.core import host, work
from benchmark.core.record import Limit, Run
from benchmark.core.trace import Tracer, span
from benchmark.inputs.scenes import render_rgb, scene_pool
from benchmark.loops.counting import EDT_SITES, count_calls
from benchmark.models import grasp_service as grasp
from benchmark.reference import frame_check


def frame_cycle(traffic: dict, seed: int, h: int, w: int, dev,
                with_rgb: bool):
    """The mix's frames as host arrays: [(mask int16, depth f32, rgb or
    None)], ``cycle_frames`` of them."""
    pool = scene_pool(seed, int(traffic["pool_scenes"]), h, w,
                      traffic["leaves"], traffic["margin_px"],
                      float(traffic["hard_share"]), dev)
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    roll = int(traffic["roll_px"])
    out = []
    for k in range(int(traffic["cycle_frames"])):
        # every pool scene in turn (the pool is in a seeded order), so
        # every seed serves the same leaf counts and margins
        mask, depth = pool[k % len(pool)]
        dy, dx = (int(v) for v in rng.integers(-roll, roll + 1, 2))
        m = torch.roll(mask, (dy, dx), (0, 1))
        d = torch.roll(depth, (dy, dx), (0, 1))
        rgb = render_rgb(m, gen).cpu().numpy() if with_rgb else None
        out.append((m.cpu().numpy(), d.cpu().numpy(), rgb))
    return out


def _spanning(fn, name):
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapped


class _Spanned:
    """The hybrid selector seen through a span around its rerank."""

    def __init__(self, inner):
        self.inner = inner

    def select_grasp_point(self, *args, **kwargs):
        with span("rerank"):
            return self.inner.select_grasp_point(*args, **kwargs)


def build_service(cfg, cnn, selector, dev, config: dict):
    """``GraspService`` with the frame function seen through a span."""
    from leafgrasp_tpu_torch.pipeline import ingest
    orig = ingest.make_frame_fn
    ingest.make_frame_fn = lambda *a, **k: _spanning(orig(*a, **k),
                                                     "frame_fn")
    try:
        return ingest.GraspService(
            cfg, cnn=cnn,
            hybrid_selector=None if selector is None else _Spanned(selector),
            min_interval_s=0.0,
            pipeline_depth=int(config.get("pipeline_depth", 0)),
            device=dev, hist_median=bool(config.get("hist_median", False)))
    finally:
        ingest.make_frame_fn = orig


def _stage_totals(service) -> dict:
    return {k: (v["total_s"], v["count"])
            for k, v in service.timer.summary().items()}


def _stage_delta(before: dict, after: dict) -> dict:
    out = {}
    for k, (s, n) in after.items():
        s0, n0 = before.get(k, (0.0, 0))
        out[k] = {"total_s": s - s0, "count": n - n0}
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        overrides: dict) -> Run:
    from leafgrasp_tpu_torch import config as pconfig
    from leafgrasp_tpu_torch.utils.device import host_reads
    config, traffic = cell.config, dict(cell.traffic, **overrides)
    model = importlib.import_module(f"benchmark.models.{config['model']}")
    frame_config = model.frame_config(config)
    vla = model.build_rerank(config, seed, dev, overrides, traffic)
    cfg = grasp.pipeline_config(frame_config, pconfig, overrides)
    state = grasp.cnn_state(cfg, seed, dev)
    cnn = grasp.program_cnn(cfg, state, dev)
    cnn_calls = {"rows": 0}

    def _count(_mod, inp, _out):
        cnn_calls["rows"] += int(inp[0].shape[0])
    cnn.register_forward_hook(_count)
    service = build_service(cfg, cnn, None if vla is None else vla.selector,
                            dev, frame_config)
    h, w = cfg.frame.height, cfg.frame.width
    frames = frame_cycle(traffic, seed, h, w, dev, bool(traffic["rgb"]))
    order = np.random.default_rng([seed, 2]).permutation(len(frames))

    def serve(i: int):
        mask, depth, rgb = frames[order[i % len(frames)]]
        t0 = time.perf_counter()
        with span("service_call"):
            if rgb is not None:
                service.on_rgb(rgb)
            service.on_mask(mask, i + 1)
            service.on_depth(depth, i + 1)
            out = service.process_pending(force=True)
        t1 = time.perf_counter()
        return t0, t1, out

    def rerank_of_frame():
        """(failed, the rerank's record or None) of the frame just
        served."""
        if vla is None:
            return False, None
        rec = vla.take()
        if not rec["ran"]:
            return False, None
        return rec["failed"], None if rec["failed"] else rec

    for i in range(int(traffic["warmup_frames"])):
        serve(len(frames) - 1 - i)
        rerank_of_frame()
    if vla is not None:
        vla.records.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    served, item_s, lasts = [], [], []
    failed = 0
    reads0, stages0 = host_reads(), _stage_totals(service)
    # the set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    host0 = host.snapshot()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    i = 0
    while True:
        t0, t1, out = serve(i)
        bad, rec = rerank_of_frame()
        if out is not None and not bad:
            item_s.append(t1 - t0)
            served.append((i, frame_check.published(out), rec,
                           out.get("vla")))
            if rec is not None:
                lasts.append(rec["last"])
        else:
            failed += 1
        i += 1
        if t1 >= deadline:
            break
    window_s = t1 - t_win
    host_facts = host.window_facts(host0, host.snapshot())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    stages = _stage_delta(stages0, _stage_totals(service))
    reads = host_reads() - reads0
    attempted = i

    # the traced tail: more frames of the same loop under the profiler,
    # with the kernels' operands counted; device readings come from it,
    # host-clock readings from the window above
    counts: dict = {}
    summary = None
    n_traced = int(traffic["trace_frames"]) if trace else 0
    if n_traced:
        rows0 = cnn_calls["rows"]
        with count_calls(EDT_SITES, counts, "edt_bytes"):
            if vla is not None:
                vla.count_work(counts)
            with Tracer() as tracer:
                for j in range(n_traced):
                    _, _, out = serve(i + j)
                    bad, _ = rerank_of_frame()
                    if out is None or bad:
                        failed += 1
                    attempted += 1
            if vla is not None:
                vla.stop_counting()
        counts["cnn_flop"] = work.cnn_forward_flop(
            frame_config["pipeline"]["model"], cnn_calls["rows"] - rows0,
            cfg.fusion.patch_size)
        summary = tracer.reduce(n_traced)

    def check():
        nonlocal service, cnn
        service.bus.close()
        del service, cnn
        if vla is not None:
            vla.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = judge_frames(cell, cfg.camera, frame_config, state, frames,
                           order, served, seed, dev, overrides, vla,
                           failed, facts)
        facts["check_s"] = time.perf_counter() - t0
        return out

    facts = {"frames": float(len(item_s)), **host_facts}
    return Run(kind="serve", setup_s=setup_s, window_s=window_s,
               attempted=attempted, failed=failed,
               memory_peak_bytes=int(peak), item_s=item_s, stages=stages,
               host_reads=reads, vla=lasts, trace=summary, work=counts,
               check=check, facts=facts)


def judge_frames(cell, camera, config, state, frames, order, served,
                 seed, dev, overrides, vla, failed, facts):
    """The numbers compared: every judged frame's readings, worst first,
    and the failed frames."""
    from benchmark.reference.grasp_ref import config as rconfig
    limits = cell.limits
    traffic = dict(cell.traffic, **overrides)
    ref_cfg = grasp.pipeline_config(config, rconfig, overrides)
    ref_cnn = grasp.reference_cnn(ref_cfg, state, dev)
    rng = np.random.default_rng([seed, 3])
    # one served frame a distinct cycle frame, then a seeded sample
    firsts = {}
    for rec in served:
        firsts.setdefault(order[rec[0] % len(frames)], rec)
    pool = list(firsts.values())
    k = min(int(traffic["check_frames"]), len(pool))
    picks = [pool[j] for j in sorted(rng.choice(len(pool), k,
                                                replace=False))]
    readings = []
    hist = bool(config.get("hist_median", False))
    repick_differs = rows_differ = repicked = 0
    for i, pub, rec, choice in picks:
        mask, depth, _ = frames[order[i % len(frames)]]
        ref = frame_check.reference_frame(mask, depth, camera, ref_cnn,
                                          ref_cfg, dev, hist)
        if rec is not None:
            # the reference's re-pick from the served tokens; the frame
            # function runs again on a mask of that leaf alone where it
            # differs from the frame's own leaf
            want = vla.reference_choice(ref, rec)
            got = -1 if choice is None else int(choice["leaf_id"])
            repick_differs += int(want["leaf"] != got)
            rows_differ += want["rows_differ"]
            leaf = want["leaf"]
            if leaf >= 0 and leaf != int(ref.leaf_id):
                repicked += 1
                ref = frame_check.reference_frame(
                    np.where(mask == leaf, leaf, 0).astype(np.int16),
                    depth, camera, ref_cnn, ref_cfg, dev, hist)
        readings.append(frame_check.judge(ref, pub))
    agg = frame_check.worst(readings)
    facts.update(judged=agg["frames"], judged_same_pixel=agg["same_pixel"],
                 judged_found=float(sum(p[1]["found"] for p in picks)))
    out = [Limit("failed_frames", float(failed), 0.0),
           Limit("flag_mismatch", agg["flags"], 0.0),
           Limit("leaf_gap", agg["leaf_gap"], limits.get("leaf_gap", 0.0)),
           Limit("pixel_gap", agg["pixel_gap"],
                 limits.get("pixel_gap", 0.0)),
           Limit("xyz_err_m", agg["xyz_err_m"],
                 limits.get("xyz_err_m", 0.0))]
    if vla is not None:
        facts.update(judged_reranks=float(sum(p[2] is not None
                                              for p in picks)),
                     judged_repicked=float(repicked))
        out += [Limit("rows_differ", float(rows_differ), 0.0),
                Limit("repick_differs", float(repick_differs), 0.0)]
        out += vla.check(seed, limits, facts)
    return out
