#!/usr/bin/env python3
"""Per-stage split of the port's frame on the card: one tool for the
JAX package's four stage tools (tools/micro_bench_stages.py,
micro_bench_iso.py, micro_bench_iso2.py and micro_bench_envelope.py),
under their scenes and definitions. Eager CUDA fuses no stage into
another, so each stage below is timed standalone as the JAX tools timed
their jitted stages.

Groups, each on the JAX tool's scene at the production frame (1080 x
1440, ``max_leaves=16``, the seeded standard CNN):

  stages    the ``crowded`` bench scene (12 leaves, seed 3, margin 60),
            its largest leaf: leaf stats, leaf choice, exact
            minAreaRect, the 2-channel pass 1, the close and wide
            interference pass 1, the 3-field envelope maxima, the 320^2
            window pass 2, the grasp scores in both modes and the full
            frame in both modes (micro_bench_stages.py:128-140), and the
            full frame once more from host arrays (its inputs' copies to
            the device inside it, as a service hands frames over);
  iso       the ``sparse`` scene (6 leaves, seed 8), its selected leaf:
            the two dilations, ``edt_batch`` (K5) on 2, 4 and the 2
            interference channels, the scores and the frame in both
            modes (micro_bench_iso.py:92-103);
  iso2      the same scene: the 4-channel pass 1, the banded inside EDT
            (K3/K4), the outside maximum, the banded interference pair
            and the interference maxima pair (micro_bench_iso2.py:118-129);
  envelope  the ``crowded`` scene, leaf 5, the union mode's three wide
            fields: A the envelope's sampled-column scan at stride 8 and
            16, B its tile candidates at k 2048 and 512, C the
            refinement of those candidates (the JAX tool names C and
            never times it), D ``edt_max_argmax_batch`` at stride/k
            8/2048, 16/512 and 16/1024 (their maxima must agree, else
            the tool raises), E ``leaf_stats`` at ``max_leaves=8`` with
            the bisection medians and with the histogram (K6)
            (micro_bench_envelope.py).

Each stage reports:
  ms          ms a call of ``--n`` calls back to back between two
              barriers (CUDA events; the JAX tools' ``t()``), best of
              ``--reps``;
  alone_ms    one call between two barriers (CUDA events), the best
              of ``--reps``;
  host_ms     the host clock of that best call until it returned: its
              dispatch and the waits of its blocking host reads (the
              port waits inside the stage that reads), without the
              device's tail;
  busy_ms     the device time of its kernels, copies and fills, from
              ``torch.profiler``, and ``device_ops``, how many it ran
              (not measured with ``--no-profile`` or off a card);
  launches    each kernel's launches in one call, and ``host_reads``.
The full frame's ``ms`` and ``alone_ms`` put a frame back to back beside
a frame alone. Each stage's output is kept for the tests.

Prints the JAX tools' lines, then one JSON line with every stage's
numbers and ``device`` (the card's name and power limit).

    python tools/micro_bench_stages_torch.py [--n 25 --reps 3]
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_bench import (device_stamp, device_time,  # noqa: E402
                                event_ms, one_call)
from tools._torch_eval import (CAMERA, add_device_arg,  # noqa: E402
                               setup_device)

# (num_leaves, seed, margin) of the JAX tools' scenes
SCENES = {"crowded": (12, 3, 60), "sparse": (6, 8, 120)}
ENVELOPE_LEAF = 5
ENVELOPE_MAX_LEAVES = 8
ENVELOPE_CAMERA = (707.9, 494.1, 1750.7)
ENVELOPE_STRIDES = (8, 16)
ENVELOPE_KS = (2048, 512)
ENVELOPE_SETTINGS = ((8, 2048), (16, 512), (16, 1024))
WINDOW = 320
MODES = ("reference_self", "union")


def scene(cfg, name, dev, scenes=SCENES):
    """(mask int32, depth f32) of scene ``name`` on ``dev``."""
    import torch
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    n, seed, margin = scenes[name]
    mask, depth = make_leaf_scene(cfg.frame.height, cfg.frame.width,
                                  num_leaves=n, seed=seed, margin=margin)
    return (torch.as_tensor(mask).to(dev), torch.as_tensor(depth).to(dev))


def _kernels(cfg):
    from leafgrasp_tpu_torch.ops.morphology import elliptical_kernel
    return (elliptical_kernel(cfg.grasp.isolation_close_kernel),
            elliptical_kernel(cfg.grasp.isolation_wide_kernel))


def _scalars(camera, dev):
    import torch
    return tuple(torch.tensor(np.float32(v), device=dev) for v in camera)


def _frame_fn(cfg, mode, dev):
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    return make_frame_fn(cfg.replace(grasp=dataclasses.replace(
        cfg.grasp, isolation_context=mode)), with_cnn=True, device=dev)


def _frame_and_score_stages(cfg, md, dd, leaf, allm, cnn, dev, camera):
    """The grasp scores and the full frame in both modes."""
    from leafgrasp_tpu_torch.geometry.grasp_scorer import \
        compute_grasp_scores
    cx, cy, f = _scalars(camera, dev)
    cam = tuple(np.float32(v) for v in camera)
    out = {}
    for mode in MODES:
        g = dataclasses.replace(cfg.grasp, isolation_context=mode)
        out[f"scores_{mode}"] = (lambda g=g: compute_grasp_scores(
            leaf, allm, dd, cx, cy, f, cfg=g))
    for mode in MODES:
        fn = _frame_fn(cfg, mode, dev)
        out[f"frame_{mode}"] = (lambda fn=fn: fn(md, dd, *cam, cnn))
    return out


def stages_group(cfg, md, dd, cnn, dev, camera=CAMERA):
    """micro_bench_stages.py's stages on (md, dd), its largest leaf."""
    import torch
    from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
    from leafgrasp_tpu_torch.ops.components import leaf_stats
    from leafgrasp_tpu_torch.ops.edt import (directional_seed_dist_1d,
                                             edt_max_argmax_batch,
                                             nearest_seed_dist_1d,
                                             squared_edt_window)
    from leafgrasp_tpu_torch.ops.morphology import dilated_vertical_dist
    from leafgrasp_tpu_torch.ops.pca import min_area_rect
    from leafgrasp_tpu_torch.utils.device import host_read
    h, w = md.shape
    ids, areas = torch.unique(md[md > 0], return_counts=True)
    ld = md == ids[torch.argmax(areas)]
    od = (md > 0) & ~ld
    ad = md > 0
    kc, kw = _kernels(cfg)
    cx, cy, f = _scalars(camera, dev)
    win = min(WINDOW, h, w)

    def dvd(o):
        du, dn = directional_seed_dist_1d(o, axis=0)
        return dilated_vertical_dist(du, dn, kc), \
            dilated_vertical_dist(du, dn, kw)

    def env_maxes():
        gc, gw = (x.to(torch.float32) for x in dvd(od))
        g = nearest_seed_dist_1d(ld, axis=1).to(torch.float32)
        return edt_max_argmax_batch(torch.stack([g * g, gc * gc, gw * gw]))

    def window():
        g = nearest_seed_dist_1d(torch.stack([~ld, ld]),
                                 axis=1).to(torch.float32)
        rows, cols = ld.any(dim=1), ld.any(dim=0)
        r0, c0 = host_read(torch.stack([
            torch.clamp(torch.argmax(rows.to(torch.int32)), 0, h - win),
            torch.clamp(torch.argmax(cols.to(torch.int32)), 0, w - win)]))
        return squared_edt_window(g * g, r0, c0, win, win)

    out = {"leaf_stats": lambda: leaf_stats(md, dd, cfg.frame.max_leaves,
                                            cx, cy, f),
           "select_optimal_leaf": lambda: select_optimal_leaf(
               md, dd, cx, cy, f, cfg.leaf, cfg.frame),
           "min_area_rect": lambda: min_area_rect(ld),
           "pass1_2ch": lambda: nearest_seed_dist_1d(
               torch.stack([~ld, ld]), axis=1),
           "dvd_close_wide": lambda: dvd(od),
           "envelope_maxes_3": env_maxes,
           "window_pass2": window}
    out.update(_frame_and_score_stages(cfg, md, dd, ld, ad, cnn, dev,
                                       camera))
    # the frame from host arrays, as chip_smoke.py's phase 3 and the
    # service hand it over: their copies to the device are in the frame
    host = (md.cpu().numpy(), dd.cpu().numpy())
    cam = tuple(np.float32(v) for v in camera)
    for mode in MODES:
        out[f"frame_{mode}_from_host"] = (
            lambda fn=_frame_fn(cfg, mode, dev): fn(*host, *cam, cnn))
    return out, {"leaf": ld, "other": od}


def iso_groups(cfg, md, dd, cnn, dev, camera=CAMERA):
    """({iso stage: call}, {iso2 stage: call}, inputs) on (md, dd), its
    selected leaf (micro_bench_iso.py, micro_bench_iso2.py)."""
    import torch
    from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
    from leafgrasp_tpu_torch.ops.edt import (edt_batch, edt_max_argmax,
                                             nearest_seed_dist_1d,
                                             squared_edt)
    from leafgrasp_tpu_torch.ops.morphology import dilate
    from leafgrasp_tpu_torch.utils.device import host_read
    cx, cy, f = _scalars(camera, dev)
    best = host_read(select_optimal_leaf(md, dd, cx, cy, f, cfg.leaf,
                                         cfg.frame).best_leaf_id)
    m = md == best
    allm = md > 0
    o = allm & ~m
    kc, kw = _kernels(cfg)

    def iso_pass1():
        sc, sw = dilate(o, kc), dilate(o, kw)
        g = nearest_seed_dist_1d(torch.stack([sc, sw]),
                                 axis=1).to(torch.float32)
        return sc, sw, g * g

    def iso_banded():
        sc, sw, g2 = iso_pass1()
        return (squared_edt(sc, g2=g2[0], band_mask=m),
                squared_edt(sw, g2=g2[1], band_mask=m))

    def iso_maxes():
        sc, sw, g2 = iso_pass1()
        return (edt_max_argmax(sc, g2=g2[0]), edt_max_argmax(sw, g2=g2[1]))

    def pass1_4ch():
        seeds = torch.stack([~m, m, dilate(o, kc), dilate(o, kw)])
        g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
        return g * g

    iso = {"dilates_only": lambda: (dilate(o, kc), dilate(o, kw)),
           "edt2_parity": lambda: edt_batch(torch.stack([~m, m])),
           "edt4_enhanced": lambda: edt_batch(torch.stack(
               [~m, m, dilate(o, kc), dilate(o, kw)])),
           "edt_iso_only": lambda: edt_batch(torch.stack(
               [dilate(o, kc), dilate(o, kw)]))}
    iso.update(_frame_and_score_stages(cfg, md, dd, m, allm, cnn, dev,
                                       camera))
    iso2 = {"pass1_4ch": pass1_4ch,
            "din_banded": lambda: squared_edt(~m),
            "maxdout": lambda: edt_max_argmax(m),
            "iso_banded_pair": iso_banded,
            "iso_maxes_pair": iso_maxes}
    return iso, iso2, {"leaf": m, "other": o}


def envelope_fields(cfg, mask, leaf_id=ENVELOPE_LEAF):
    """micro_bench_envelope.py's ``build_g2``: the squared pass-1 fields
    of the outside distance and the close and wide interference, (3, H,
    W) f32."""
    import torch
    from leafgrasp_tpu_torch.ops.edt import directional_seed_dist_1d
    from leafgrasp_tpu_torch.ops.morphology import \
        dilated_vertical_dist_multi
    m = mask == leaf_id
    other = (mask > 0) & ~m
    d3u, d3d = directional_seed_dist_1d(torch.stack([~m, m, other]), axis=1)
    g = torch.minimum(d3u[:2], d3d[:2]).to(torch.float32)
    gc, gw = (x.to(torch.float32) for x in dilated_vertical_dist_multi(
        d3u[2], d3d[2], _kernels(cfg)))
    return torch.stack([g[1] * g[1], gc * gc, gw * gw])


def envelope_group(cfg, md, dd, dev):
    """micro_bench_envelope.py's substages A-E (and C, which it names)."""
    import torch
    from leafgrasp_tpu_torch.ops.components import leaf_stats
    from leafgrasp_tpu_torch.ops.edt import (_pass2, _refine, _sample_cols,
                                             _tile_candidates,
                                             edt_max_argmax_batch,
                                             exact_sqrt)
    g2 = envelope_fields(cfg, md)
    c, h, w = g2.shape
    flat_rows = g2.reshape(c * h, w)
    cf = torch.zeros(3, dtype=torch.bool, device=dev)
    out = {}
    for stride in ENVELOPE_STRIDES:
        js = _sample_cols(w, stride, dev)
        ws = js.shape[0]

        def pass_a(js=js, ws=ws):
            return exact_sqrt(_pass2(flat_rows, h, qcol=js)) \
                .reshape(c, h, ws)
        out[f"A_pass_a_stride{stride}"] = pass_a
        ds0 = pass_a()[0]
        for k in ENVELOPE_KS:
            out[f"B_tile_candidates_stride{stride}_k{k}"] = (
                lambda ds0=ds0, k=k: _tile_candidates(ds0, k))
            flat = _tile_candidates(ds0, k)[1]
            out[f"C_refine_stride{stride}_k{k}"] = (
                lambda flat=flat, js=js, s=stride: _refine(
                    g2[0], flat, js, s // 2, h))
    for stride, k in ENVELOPE_SETTINGS:
        out[f"D_batch_stride{stride}_k{k}"] = (
            lambda s=stride, k=k: edt_max_argmax_batch(
                g2, stride=s, k=k, constant_field=cf))
    cam = _scalars(ENVELOPE_CAMERA, dev)
    out["E_leaf_stats_bisection"] = lambda: leaf_stats(
        md, dd, ENVELOPE_MAX_LEAVES, *cam)
    out["E_leaf_stats_histogram"] = lambda: leaf_stats(
        md, dd, ENVELOPE_MAX_LEAVES, *cam, hist_median=True)
    return out, {"g2": g2}


def time_stage(fn, dev, n: int, reps: int, profile: bool):
    """(record, output) of one stage: see the module docstring."""
    out = fn()                                      # warm-up
    rec = None
    for _ in range(reps):
        r, out = one_call(fn, dev)
        if rec is None or r["alone_ms"] < rec["alone_ms"]:
            rec = r
    rec["ms"] = min(event_ms(fn, dev, n) for _ in range(reps))
    rec.update(device_time(fn, dev) if profile else
               {"busy_ms": None, "device_ops": None})
    return rec, out


def build_stages(cfg, cnn, dev, scenes=SCENES, camera=CAMERA):
    """({group/stage: zero-argument call}, {group: the stages' inputs})."""
    crowded = scene(cfg, "crowded", dev, scenes)
    sparse = scene(cfg, "sparse", dev, scenes)
    stages, inputs = {}, {}
    st, inputs["stages"] = stages_group(cfg, *crowded, cnn, dev, camera)
    iso, iso2, inputs["iso"] = iso_groups(cfg, *sparse, cnn, dev, camera)
    env, inputs["envelope"] = envelope_group(cfg, *crowded, dev)
    for group, calls in (("stages", st), ("iso", iso), ("iso2", iso2),
                         ("envelope", env)):
        stages.update({f"{group}/{k}": v for k, v in calls.items()})
    return stages, inputs


def measure(cfg, cnn, dev, n: int = 25, reps: int = 3,
            profile: bool = True, scenes=SCENES, camera=CAMERA):
    """({group/stage: record}, {group/stage: output}, {group: inputs});
    raises unless the envelope's D settings give equal maxima."""
    import torch
    stages, inputs = build_stages(cfg, cnn, dev, scenes, camera)
    recs, outs = {}, {}
    for name, fn in stages.items():
        recs[name], outs[name] = time_stage(fn, dev, n, reps, profile)
    maxes = {name: outs[name][0] for name in outs
             if name.startswith("envelope/D_")}
    first = next(iter(maxes.values()))
    for name, mx in maxes.items():
        if not torch.equal(mx, first):
            raise RuntimeError(f"{name}: maxima {mx.tolist()} != "
                               f"{first.tolist()}")
    return recs, outs, inputs


def main(argv=None, outputs=None):
    """Time every stage and print the lines and the record; returns the
    record. ``outputs``, a dict, receives each stage's output."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-profile", action="store_true",
                    help="leave out the profiler's device time")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    cnn, _ = init_grasp_cnn(0, DEFAULT_CONFIG.model)
    cnn = cnn.to(dev).eval()
    recs, outs, _ = measure(DEFAULT_CONFIG, cnn, dev, args.n, args.reps,
                            not args.no_profile)
    for name, r in recs.items():
        busy = "not measured" if r["busy_ms"] is None \
            else f"{r['busy_ms']:7.2f} ({r['device_ops']} ops)"
        print(f"{name:44s} {r['ms']:7.2f} ms  alone {r['alone_ms']:7.2f}  "
              f"host {r['host_ms']:7.2f}  busy {busy}  launches "
              f"{sum(r['launches'].values())}  reads {r['host_reads']}",
              flush=True)
    print(f"   maxes agree: {len(ENVELOPE_SETTINGS)} settings", flush=True)
    rec = {"tool": "micro_bench_stages", "n": args.n, "reps": args.reps,
           "envelope_maxes_agree": True, "stages": recs,
           "device": device_stamp(dev)}
    print(json.dumps(rec), flush=True)
    if outputs is not None:
        outputs.update(outs)
    return rec


if __name__ == "__main__":
    main()
