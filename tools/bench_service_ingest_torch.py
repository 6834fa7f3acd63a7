#!/usr/bin/env python3
"""GraspService throughput with real ingest on the service thread, on
the PyTorch port: the counterpart of tools/bench_service_ingest.py.

A producer THREAD pushes raw (int16 mask, f32 depth) frames through the
C++ frame bus (native/framebus.cpp, built by the port into
build/native/) as a camera callback would, so every frame pays the full
bus, staging, upload and dispatch path, while the consumer loop drains
the service with ``pipeline_depth`` overlap. The bus keeps the newest
frame, so a slow consumer drops frames; the record counts them.

Prints ONE JSON line with the JAX tool's keys:
  * value (service frames/s), frames pushed / processed / dropped,
  * dispatch_plus_ingest_ms_mean: host time of a ``process_pending``
    call that returned a result,
  * bus: "native" or "numpy" (which bus the service ran),
plus ``device``: the card's name and power limit.

    python tools/bench_service_ingest_torch.py [--frames 200] [--depth 3]
    python tools/bench_service_ingest_torch.py --host-only
    python tools/bench_service_ingest_torch.py --device cpu --frames 6
"""
import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from tools._torch_bench import device_stamp  # noqa: E402
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402

# (seed, leaves, margin) of bench.py's three families
# (bench_service_ingest.py:121)
FAMILIES = ((8, 6, 120), (3, 12, 60), (5, 3, 260))


def host_only(n_frames: int, dev):
    """The HOST ingest path alone: bus push (producer thread) ->
    try_get_pair -> the int16 staging copy GraspService makes before
    dispatch; no device work (bench_service_ingest.py:38)."""
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.io.framebus import FrameBus
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene

    h, w = DEFAULT_CONFIG.frame.height, DEFAULT_CONFIG.frame.width
    mask, depth = make_leaf_scene(h, w, num_leaves=8, seed=8, margin=100)
    raws = [(np.roll(mask, 5 * i, axis=1), np.roll(depth, 5 * i, axis=1))
            for i in range(8)]
    bus = FrameBus(h, w)
    state = {"consumed": 0, "taken": -1}
    done = threading.Event()

    def producer():
        # waits on the newest frame taken: counting the frames taken (as
        # the JAX tool does) deadlocks once the bus has dropped two
        for i in range(n_frames):
            m, d = raws[i % len(raws)]
            bus.push_mask(m, stamp_us=i)
            bus.push_depth(d, stamp_us=i)
            while i - state["taken"] > 1 and not done.is_set():
                time.sleep(0)
        done.set()

    th = threading.Thread(target=producer, daemon=True)
    per_frame_ms = []
    th.start()
    t0 = time.perf_counter()
    while state["consumed"] < n_frames:
        t_in = time.perf_counter()
        pair = bus.try_get_pair()
        if pair is None:
            if done.is_set() and bus.try_get_pair() is None:
                break
            time.sleep(0)
            continue
        m, d, state["taken"], _ = pair
        m16 = np.ascontiguousarray(m, np.int16)   # the staging copy
        assert m16.shape == (h, w) and d.dtype == np.float32
        state["consumed"] += 1
        per_frame_ms.append((time.perf_counter() - t_in) * 1e3)
    wall = time.perf_counter() - t0
    th.join(timeout=5)
    native = bus.is_native
    bus.close()
    return {
        "metric": "host_ingest_ms_per_frame",
        "value": round(float(np.mean(per_frame_ms)), 3),
        "unit": "ms (pop+stage, consumer side)",
        "p95_ms": round(float(np.percentile(per_frame_ms, 95)), 3),
        "frames": state["consumed"],
        "host_ingest_fps_bound": round(state["consumed"] / wall, 1),
        "bus": "native" if native else "numpy",
        "note": "producer push runs concurrently on its own thread; "
                "the wall-clock fps bound includes it",
        "device": device_stamp(dev),
    }


def ingest_config():
    """DEFAULT_CONFIG with ``reference_self`` isolation
    (bench_service_ingest.py:111-112)."""
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, GraspScoringConfig
    return DEFAULT_CONFIG.replace(grasp=GraspScoringConfig(
        isolation_context="reference_self"))


def raw_frames(cfg, n: int):
    """The raw frames a camera would hand over: rolled variants of the
    three families, in family order (bench_service_ingest.py:119-127),
    the margins scaled to the frame's rows (as given at 1080)."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    h, w = cfg.frame.height, cfg.frame.width
    raws = []
    for seed, leaves, margin in FAMILIES:
        mask, depth = make_leaf_scene(h, w, num_leaves=leaves, seed=seed,
                                      margin=margin * h // 1080)
        for i in range(max(1, n // 3)):
            raws.append((np.roll(mask, 5 * i, axis=1),
                         np.roll(depth, 5 * i, axis=1)))
    return raws[:n]


def run_ingest(cfg, raws, cnn, depth: int, dev):
    """Drive a GraspService with a producer thread over ``raws``; returns
    (the record's measured fields, the published result dicts)."""
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService

    results = []
    svc = GraspService(cfg, cnn=cnn, publish=None, on_result=results.append,
                       min_interval_s=0.0, pipeline_depth=depth, device=dev)
    svc.set_camera_params(default_projection())

    # warm up on one frame (allocator, cuDNN plans), then reset
    svc.on_mask(raws[0][0])
    svc.on_depth(raws[0][1])
    svc.process_pending(force=True)
    svc.flush()
    results.clear()

    done = threading.Event()
    state = {"processed": 0, "taken": -1}
    take = svc.bus.try_get_pair

    def tracked_take():
        pair = take()
        if pair is not None:
            state["taken"] = pair[2]
        return pair

    svc.bus.try_get_pair = tracked_take

    def producer():
        # a camera callback thread: at most two frames beyond the newest
        # one the service took, so the newest-frame bus may drop one,
        # and the drops are reported. (The JAX tool waits on the count of
        # finished frames, which a dropped frame never joins: after a few
        # drops its producer and consumer wait on each other.)
        for i, (m, d) in enumerate(raws):
            svc.on_mask(m, stamp_us=i)
            svc.on_depth(d, stamp_us=i)
            while i - state["taken"] > 2 and not done.is_set():
                time.sleep(0)
        done.set()

    ingest_ms = []
    t0 = time.perf_counter()
    th = threading.Thread(target=producer, daemon=True)
    th.start()
    while True:
        t_in = time.perf_counter()
        out = svc.process_pending(force=True)
        if out is not None:
            state["processed"] += 1
            ingest_ms.append((time.perf_counter() - t_in) * 1e3)
        elif done.is_set():
            # the producer may have pushed its last pair after this poll
            out = svc.process_pending(force=True)
            if out is None:
                break
            state["processed"] += 1
            ingest_ms.append((time.perf_counter() - t_in) * 1e3)
        else:
            time.sleep(0)
    svc.flush()
    dt = time.perf_counter() - t0
    th.join(timeout=5)
    native = svc.bus.is_native
    svc.stop()
    # flush() finalizes the frames still in flight; the published count
    # is the completed total
    processed = len(results)
    fields = {
        "value": round(processed / dt, 3),
        "frames_processed": processed,
        "frames_dropped": len(raws) - processed,
        "dispatch_plus_ingest_ms_mean": round(float(np.mean(ingest_ms)), 3)
        if ingest_ms else None,
        "bus": "native" if native else "numpy",
        "results_published": len(results),
    }
    return fields, results


def main(argv=None, published=None):
    """Run the tool and print its record; returns it. ``published``, a
    list, receives (mask stamp, depth stamp, message) of every frame the
    service published."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--depth", type=int, default=3,
                    help="pipeline_depth (frames in flight)")
    ap.add_argument("--host-only", action="store_true",
                    help="measure bus push/pop + staging only (no device "
                         "dispatch)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    if args.host_only:
        rec = host_only(args.frames, dev)
        print(json.dumps(rec), flush=True)
        return rec

    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    cfg = ingest_config()
    raws = raw_frames(cfg, args.frames)
    cnn, _ = init_grasp_cnn(0, cfg.model)
    fields, results = run_ingest(cfg, raws, cnn.to(dev).eval(), args.depth,
                                 dev)
    rec = {
        "metric": "grasp_service_fps_with_ingest",
        "value": fields["value"],
        "unit": "frames/s",
        "frames_pushed": len(raws),
        "frames_processed": fields["frames_processed"],
        "frames_dropped": fields["frames_dropped"],
        "pipeline_depth": args.depth,
        "dispatch_plus_ingest_ms_mean":
            fields["dispatch_plus_ingest_ms_mean"],
        "bus": fields["bus"],
        "results_published": fields["results_published"],
        "device": device_stamp(dev),
    }
    print(json.dumps(rec), flush=True)
    if published is not None:
        published.extend((r["mask_stamp"], r["depth_stamp"], r["message"])
                         for r in results)
    return rec


if __name__ == "__main__":
    main()
