#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit):

1. build the five CUDA kernels from ``leafgrasp_tpu_torch/kernels/csrc``
   into ``build/kernels/`` (one ``nvcc`` per source, all started
   together);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: fused scoring at 1080 x 1440 (max abs diff
   <= 1e-5, valid mask equal), the attention gate at (20, 16, 256) in all
   four modes (<= 1e-5), the min-plus in its full, window, sampled,
   refinement and banded forms (bit-exact), the row-banded EDT at
   (1, 540, 720) and (3, 1080, 1440) (bit-exact, radii included), and the
   segment histogram at 1080 x 1440 with 18 segments (counts equal; the
   histogram median within range / 256^2 of the sorted median);
3. drive ``make_frame_fn(with_cnn=True)`` at 1080 x 1440 with the
   standard CNN (seeded weights) on the three ``bench.py`` scene families
   in the ``reference_self``, ``union`` and ``union_half`` modes, and in
   ``union_half`` once more with ``hist_median=True`` (the medians of
   leaf selection through the histogram kernel), with every launch
   count and the host-read count set to 0 just before and read just
   after; then hold the first frame of each family and variant against
   the port's own CPU path built the same way (same leaf id and grasp
   pixel), and the ``hist_median`` frames against the default's (same
   leaf, same tall leaves, same pixel);
4. profile one frame per mode (``torch.profiler``): device busy time and
   the kernels that take it;
5. drive a ``GraspService`` (``union_half``, standard CNN) on the card
   through ``on_mask`` / ``on_depth`` / ``process_pending``: once with
   ``pipeline_depth=0`` and a recorder, once with depth 2 plus
   ``flush()``, once replaying the recorded log; the three runs must
   publish the same messages in the same order, and the first frame of
   each family the message of a ``device="cpu"`` service (pixel equal,
   floats within 1e-6). A fourth service built with ``hist_median=True``
   takes the first frames of each family and must publish the default's
   messages (pixel equal, floats within 1e-6). The launch counts are set
   to 0 before and read after, and must be non-zero for every kernel.

TF32 is off for convolutions and matmuls in every phase, so the card
computes the CNN in full f32 as the CPU path does. Before the last line
it prints the card's name and power limit and one JSON line of
per-kernel numbers; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1440
CX, CY, F = np.float32(707.87), np.float32(494.07), np.float32(1750.68)
# (name, num_leaves, seed, margin): the bench families (bench.py:37-41)
FAMILIES = [("sparse", 6, 8, 120), ("crowded", 12, 3, 60),
            ("large_leaf", 3, 5, 260)]
MODES = ("reference_self", "union", "union_half")
# frame-function variants: name -> (isolation mode, hist_median)
HIST_VARIANT = "union_half+hist_median"
VARIANTS = {**{mode: (mode, False) for mode in MODES},
            HIST_VARIANT: ("union_half", True)}
FRAMES_PER_CELL = 2
SERVICE_MODE = "union_half"
SERVICE_FRAMES_PER_FAMILY = 8
SERVICE_HIST_FRAMES_PER_FAMILY = 2
SERVICE_FLOAT_TOL = 1e-6
KERNEL_FUNCTIONS = ("minplus_pass2_kernel", "fused_score_maps_kernel",
                    "fused_attention_gate_kernel", "rowband_kernel",
                    "rowband_pool_kernel", "rowband_radius_kernel",
                    "segment_histogram_kernel")
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SCORING_TOL = 1e-5
GATE_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device milliseconds of the CUDA kernel named ``kernel`` per
    call of ``fn`` (the kernel alone, without its wrapper's other ops),
    from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.key.split("(")[0].endswith(kernel))
    if total <= 0:
        raise RuntimeError(f"the profiler saw no {kernel}")
    return total / 1e3 / iters


def bound(bytes_moved: float, ops: float):
    """(least ms, what bounds it) on the published H100 peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def minplus_sources(r: int, w: int, nq: int, band=None) -> int:
    """(row, query, source) triples that a min-plus call must visit."""
    if band is None:
        return r * nq * w
    from leafgrasp_tpu_torch.kernels.minplus import BAND_COLS, BAND_ROWS
    nb = band.cpu().numpy().astype(np.int64)
    total = 0
    for rt in range(nb.shape[0]):
        rows = min(BAND_ROWS, r - rt * BAND_ROWS)
        for qt in range(nb.shape[1]):
            cols = min(BAND_COLS, nq - qt * BAND_COLS)
            lo = max(0, (qt - nb[rt, qt]) * BAND_COLS)
            hi = min(w, (qt + nb[rt, qt] + 1) * BAND_COLS)
            total += rows * cols * (hi - lo)
    return total


def check_minplus(torch, dev, leaf, other):
    """The min-plus in each form the main path calls, bit-exact."""
    from leafgrasp_tpu_torch.kernels.minplus import (
        BAND_COLS, BAND_ROWS, minplus_pass2, minplus_pass2_plain)
    from leafgrasp_tpu_torch.ops.edt import (_tile_candidates, exact_sqrt,
                                            nearest_seed_dist_1d)
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel

    seeds = torch.stack([~leaf, leaf, dilate(other, elliptical_kernel(40))])
    g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
    g2 = (g * g).contiguous()
    c3 = g2.shape[0]
    js = torch.cat([torch.arange(0, W, 16, dtype=torch.int32, device=dev),
                    torch.tensor([W - 1], dtype=torch.int32, device=dev)])
    ds = exact_sqrt(minplus_pass2_plain(g2[1], qcol=js))
    _, flat, _ = _tile_candidates(ds, 1024)
    rows = flat // js.shape[0]
    jwin = torch.clamp(js[flat % js.shape[0]].to(torch.int64)[:, None]
                       + torch.arange(-8, 9, device=dev)[None, :], 0, W - 1)
    refine_g2 = g2[1][rows].contiguous()
    hq = wq = 320
    win_g2 = g2[:, 200:200 + hq, :].reshape(c3 * hq, W).contiguous()
    band = torch.full((-(-H // BAND_ROWS), -(-W // BAND_COLS)), 2,
                      dtype=torch.int32, device=dev)
    forms = {
        "full": (g2[1], {}),
        "window": (win_g2, {"qcol": torch.arange(
            400, 400 + wq, dtype=torch.int32, device=dev)}),
        "sampled": (g2.reshape(c3 * H, W), {"qcol": js}),
        "refine": (refine_g2, {"qcol": jwin.to(torch.int32).contiguous()}),
        "banded": (g2[0].contiguous(), {"band": band}),
    }
    out = {}
    for name, (x, kw) in forms.items():
        got = minplus_pass2(x, **kw)
        want = minplus_pass2_plain(x, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"minplus {name}: kernel != plain, max abs "
                               f"diff {err}")
        r, w = x.shape
        nq = w if "qcol" not in kw else kw["qcol"].shape[-1]
        b_ms, b_by = bound(4.0 * (r * w + r * nq),
                           2.0 * minplus_sources(r, w, nq, kw.get("band")))
        out[name] = {
            "shape": [r, w, nq], "max_abs_err": err,
            "ms": kernel_ms(lambda: minplus_pass2(x, **kw),
                            "minplus_pass2_kernel"),
            "wrapper_ms": cuda_ms(lambda: minplus_pass2(x, **kw)),
            "plain_ms": cuda_ms(lambda: minplus_pass2_plain(x, **kw),
                                iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"minplus {name} {json.dumps(out[name])}")
    full = out["full"]
    return {"name": "minplus_pass2", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/minplus.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_edt.py:65",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": full["ms"], "wrapper_ms": full["wrapper_ms"],
            "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "forms": out}


def check_scoring(torch, dev, leaf, other, depth):
    """Fused scoring at 1080 x 1440 on the main path's fields."""
    from leafgrasp_tpu_torch.config import GraspScoringConfig
    from leafgrasp_tpu_torch.geometry.grasp_scorer import stem_penalty_map
    from leafgrasp_tpu_torch.kernels.scoring import (
        fused_score_maps, fused_score_maps_plain)
    from leafgrasp_tpu_torch.ops.conv import gradient_magnitude
    from leafgrasp_tpu_torch.ops.edt import edt
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel
    from leafgrasp_tpu_torch.ops.pca import min_area_rect

    cfg = GraspScoringConfig()
    din = edt(~leaf)
    dclose = edt(dilate(other, elliptical_kernel(30)))
    dwide = edt(dilate(other, elliptical_kernel(40)))
    grad = gradient_magnitude(depth * leaf.to(torch.float32))
    o = min_area_rect(leaf)
    cx, cy, f = (torch.tensor(v, device=dev) for v in (CX, CY, F))
    args = (din, torch.zeros_like(din), dclose, dwide, grad,
            leaf.to(torch.float32), stem_penalty_map(leaf, cfg), cx, cy, f,
            o.angle, o.valid)
    kw = {"cfg": cfg, "max_sdf": din.max(), "max_close": dclose.max(),
          "max_wide": dwide.max()}
    got = fused_score_maps(*args, **kw)
    want = fused_score_maps_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got[:8], want[:8]))
    if err > SCORING_TOL or not torch.equal(got[8], want[8]):
        raise RuntimeError(f"fused_score_maps: max abs err {err}, valid "
                           f"equal {torch.equal(got[8], want[8])}")
    # 7 f32 fields in, 8 f32 maps and a byte mask out; ~70 f32 ops a pixel
    b_ms, b_by = bound((7 * 4 + 8 * 4 + 1) * H * W, 70.0 * H * W)
    rec = {"name": "fused_score_maps", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/scoring.cu",
           "replaces": "leafgrasp_tpu/ops/pallas_scoring.py:130",
           "tolerance": SCORING_TOL, "max_abs_err": err,
           "ms": kernel_ms(lambda: fused_score_maps(*args, **kw),
                           "fused_score_maps_kernel"),
           "wrapper_ms": cuda_ms(lambda: fused_score_maps(*args, **kw)),
           "plain_ms": cuda_ms(lambda: fused_score_maps_plain(*args, **kw)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"fused_score_maps {json.dumps(rec)}")
    return rec


def check_attention(torch, dev):
    """The CNN's gate at its main-path shape, all four modes."""
    from leafgrasp_tpu_torch.kernels.attention import (
        MODES as GATE_MODES, attention_gate_plain, fused_attention_gate)
    rng = np.random.default_rng(0)
    n, hw, c, r = 20, 16, 256, 16

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=dev)

    x = torch.relu(t(n, hw, c))
    params = (t(c, 1, scale=c ** -0.5), t(1), t(c, r, scale=c ** -0.5),
              t(r), t(r, c, scale=r ** -0.5), t(c))
    errs, times = {}, {}
    for mode in GATE_MODES:
        got = fused_attention_gate(x, *params, mode)
        want = attention_gate_plain(x, *params, mode)
        torch.cuda.synchronize()
        errs[mode] = (got - want).abs().max().item()
        if errs[mode] > GATE_TOL:
            raise RuntimeError(f"attention {mode}: max abs err {errs[mode]}")
        times[mode] = {
            "ms": None if mode == "none" else kernel_ms(
                lambda: fused_attention_gate(x, *params, mode),
                "fused_attention_gate_kernel"),
            "wrapper_ms": cuda_ms(
                lambda: fused_attention_gate(x, *params, mode)),
            "plain_ms": cuda_ms(
                lambda: attention_gate_plain(x, *params, mode))}
    # spatial, the standard model's mode: x read once and written once,
    # a C-long dot, a sigmoid and a multiply per element
    b_ms, b_by = bound(2 * 4 * n * hw * c + 4 * (c + 1), 3.0 * n * hw * c)
    rec = {"name": "fused_attention_gate", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/attention.cu",
           "replaces": "leafgrasp_tpu/models/attention_pallas.py:63",
           "tolerance": GATE_TOL, "max_abs_err": max(errs.values()),
           "ms": times["spatial"]["ms"],
           "wrapper_ms": times["spatial"]["wrapper_ms"],
           "plain_ms": times["spatial"]["plain_ms"],
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "modes_ms": times}
    log(f"fused_attention_gate {json.dumps(rec)}")
    return rec


def rowband_pairs(nb, h: int, w: int) -> int:
    """(output, candidate row) pairs inside the tiles' row bands."""
    from leafgrasp_tpu_torch.kernels.rowband import TILE_COLS, TILE_ROWS
    nb = nb.cpu().numpy().astype(np.int64)
    rt = np.arange(nb.shape[1])
    row0 = rt * TILE_ROWS
    rows = np.minimum(TILE_ROWS, h - row0)[None, :, None]
    cols = np.minimum(TILE_COLS, w - np.arange(nb.shape[2])
                      * TILE_COLS)[None, None, :]
    lo = np.maximum(row0[None, :, None] - nb, 0)
    hi = np.minimum(row0[None, :, None] + TILE_ROWS - 1 + nb, h - 1)
    return int((rows * cols * (hi - lo + 1)).sum())


def check_rowband(torch, dev, leaf, other):
    """The row-banded EDT at the path's shape (the pooled, dilated
    interference at half resolution) and on three full frames,
    bit-exact against the full sweep, radii included."""
    from leafgrasp_tpu_torch.kernels.rowband import (
        rowband_radii_plain, squared_edt_rowband, squared_edt_rowband_plain)
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel

    inter = dilate(other, elliptical_kernel(40))
    pooled = inter.reshape(H // 2, 2, W // 2, 2).any(dim=3).any(dim=1)
    forms = {"half": pooled[None],
             "full3": torch.stack([~leaf, leaf, other])}
    out = {}
    for name, seeds in forms.items():
        g = nearest_seed_dist_1d(seeds, axis=2).to(torch.float32)
        g2r = (g * g).contiguous()
        c, h, w = g2r.shape
        got, nb = squared_edt_rowband(g2r, return_radii=True)
        want = squared_edt_rowband_plain(g2r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"rowband {name}: kernel != plain, max abs "
                               f"diff {err}")
        if not torch.equal(nb, rowband_radii_plain(g2r)):
            raise RuntimeError(f"rowband {name}: radii != plain radii")
        pairs = rowband_pairs(nb, h, w)
        b_ms, b_by = bound(8.0 * c * h * w, 2.0 * pairs)
        full_ms, _ = bound(8.0 * c * h * w, 2.0 * c * h * h * w)

        def run():
            return squared_edt_rowband(g2r)

        out[name] = {
            "shape": [c, h, w], "max_abs_err": err,
            "pairs_in_band": pairs, "pairs_full_sweep": c * h * h * w,
            "ms": kernel_ms(run, "rowband_kernel")
            + kernel_ms(run, "rowband_pool_kernel")
            + kernel_ms(run, "rowband_radius_kernel"),
            "sweep_ms": kernel_ms(run, "rowband_kernel"),
            "wrapper_ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda: squared_edt_rowband_plain(g2r),
                                iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "full_sweep_bound_ms": full_ms}
        log(f"rowband {name} {json.dumps(out[name])}")
    half = out["half"]
    return {"name": "squared_edt_rowband", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/rowband.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_edt.py:215",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": half["ms"], "wrapper_ms": half["wrapper_ms"],
            "plain_ms": half["plain_ms"], "bound_ms": half["bound_ms"],
            "bound_by": half["bound_by"], "library_ms": None, "forms": out}


def check_histogram(torch, dev, mask, depth):
    """The segment histogram at 1080 x 1440 with 18 segments, at the
    first level and at a refined level, counts equal; then the median
    built on it against the sorted median."""
    from leafgrasp_tpu_torch.kernels.histogram import (
        NBINS, segment_histogram, segment_histogram_plain)
    from leafgrasp_tpu_torch.ops.median import _refine, masked_median_hist

    num = 18
    ids = torch.clamp(mask, 0, num - 1).to(torch.int32)
    counts = torch.bincount(ids.reshape(-1).to(torch.int64), minlength=num)
    dmin, dmax = depth.min(), depth.max()
    span = torch.clamp(dmax - dmin, min=1e-12)
    lo1, w1 = dmin.expand(num).contiguous(), span.expand(num).contiguous()
    hist1 = segment_histogram(depth, ids, lo1, NBINS / w1, num)
    lo2, w2 = _refine(hist1, (counts // 2).to(torch.float32), lo1, w1)
    levels = {"level1": (lo1, NBINS / w1), "level2": (lo2, NBINS / w2)}
    out = {}
    for name, (lo, inv_w) in levels.items():
        got = segment_histogram(depth, ids, lo, inv_w, num)
        want = segment_histogram_plain(depth, ids, lo, inv_w, num)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or float(got.sum()) != H * W:
            raise RuntimeError(f"segment_histogram {name}: counts differ, "
                               f"max abs diff {err}")
        idl = ids.reshape(-1).to(torch.int64)
        key = idl * NBINS + torch.clamp(
            (depth.reshape(-1) - lo[idl]) * inv_w[idl], 0.0,
            float(NBINS - 1)).to(torch.int64)
        if not torch.equal(torch.bincount(key, minlength=num * NBINS)
                           .reshape(num, NBINS).to(torch.float32), got):
            raise RuntimeError(f"segment_histogram {name}: bincount differs")
        b_ms, b_by = bound(8.0 * H * W + 8.0 * num + 4.0 * num * NBINS,
                           4.0 * H * W)
        out[name] = {
            "max_abs_err": err,
            "ms": kernel_ms(
                lambda: segment_histogram(depth, ids, lo, inv_w, num),
                "segment_histogram_kernel"),
            "wrapper_ms": cuda_ms(
                lambda: segment_histogram(depth, ids, lo, inv_w, num)),
            "plain_ms": cuda_ms(
                lambda: segment_histogram_plain(depth, ids, lo, inv_w, num)),
            # one library call on PRECOMPUTED keys: it leaves out the
            # gather, subtract, multiply, clamp and cast that the kernel
            # does, so it is a lower limit for the library route;
            # plain_ms is the like-for-like figure
            "library_ms": cuda_ms(
                lambda: torch.bincount(key, minlength=num * NBINS)),
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"segment_histogram {name} {json.dumps(out[name])}")

    med = masked_median_hist(depth, ids, counts, num)
    med_err = 0.0
    tol = float(span) / NBINS ** 2
    for n in range(num):
        if int(counts[n]) == 0:
            continue
        want = torch.sort(depth[ids == n]).values
        k = int(counts[n])
        ref = 0.5 * (float(want[(k - 1) // 2]) + float(want[k // 2]))
        med_err = max(med_err, abs(float(med[n]) - ref))
    if med_err > tol:
        raise RuntimeError(f"masked_median_hist: off by {med_err} > {tol}")
    from leafgrasp_tpu_torch.ops.components import masked_median
    med_ms = {
        "hist_ms": cuda_ms(
            lambda: masked_median_hist(depth, ids, counts, num)),
        "bisection_ms": cuda_ms(
            lambda: masked_median(depth, ids, counts, num)),
        "max_abs_err_vs_sorted": med_err, "tolerance": tol}
    log(f"masked_median {json.dumps(med_ms)}")
    first = out["level1"]
    return {"name": "segment_histogram", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/histogram.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_median.py:76",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": first["ms"], "wrapper_ms": first["wrapper_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "levels": out,
            "median": med_ms}


def check_kernels(torch, dev, mask_np, depth_np):
    """Phase 2: each kernel against its plain version."""
    mask = torch.as_tensor(mask_np.astype(np.int32), device=dev)
    depth = torch.as_tensor(depth_np, device=dev)
    leaf = mask == 1
    other = (mask > 0) & ~leaf
    return [check_minplus(torch, dev, leaf, other),
            check_scoring(torch, dev, leaf, other, depth),
            check_attention(torch, dev),
            check_rowband(torch, dev, leaf, other),
            check_histogram(torch, dev, mask, depth)]


def run_frames(torch, dev, fns, model, scenes):
    """Phase 3a: the main path on the card, counted and timed."""
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.utils.device import (host_reads,
                                                  reset_host_reads)
    results, frame_ms = {}, {}
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()
    for mode in VARIANTS:
        for name, *_ in FAMILIES:
            mask, depth = scenes[name]
            times = []
            for i in range(FRAMES_PER_CELL):
                m_i = np.roll(mask, 3 * i, axis=1)
                d_i = np.roll(depth, 3 * i, axis=1)
                t0 = time.perf_counter()
                res = fns[mode](m_i, d_i, CX, CY, F, model)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    results[(mode, name)] = res
            frame_ms[f"{mode}/{name}"] = {
                "median_ms": statistics.median(times), "ms": times}
    reads = host_reads()
    counts = launch_counts()
    return results, counts, reads, frame_ms


def cross_check(results, cfgs, model_cpu, scenes):
    """Phase 3b: the first frame of each cell against the CPU path built
    the same way, and the ``hist_median`` cells against the default's."""
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    for (mode, name), res in results.items():
        uv = res.grasp_uv.cpu().numpy()
        xyz = res.grasp_xyz.cpu().numpy()
        if uv.shape != (2,) or not np.isfinite(xyz).all() \
                or not bool(res.found):
            raise RuntimeError(f"{mode}/{name}: bad frame result {uv} {xyz}")
        iso, hist = VARIANTS[mode]
        ref = make_frame_fn(cfgs[iso], with_cnn=True, device="cpu",
                            hist_median=hist)(
            *scenes[name], CX, CY, F, model_cpu)
        got = (int(res.leaf_id), uv.tolist(), bool(res.degenerate))
        want = (int(ref.leaf_id), ref.grasp_uv.numpy().tolist(),
                bool(ref.degenerate))
        log(f"frame {mode}/{name}: card (leaf, uv, degenerate) {got} "
            f"cpu {want}")
        if got != want:
            raise RuntimeError(f"{mode}/{name}: card {got} != cpu {want}")
    for name, *_ in FAMILIES:
        a = results[(VARIANTS[HIST_VARIANT][0], name)]
        b = results[(HIST_VARIANT, name)]
        got = (int(b.leaf_id), b.leaf_selection.is_tall.tolist(),
               b.grasp_uv.tolist())
        want = (int(a.leaf_id), a.leaf_selection.is_tall.tolist(),
                a.grasp_uv.tolist())
        log(f"leaf choice {name}: hist_median leaf {got[0]}, default "
            f"{want[0]}")
        if got != want:
            raise RuntimeError(f"{name}: hist_median {got} != default {want}")


def profile_frames(torch, fns, model, scenes):
    """Phase 4: device busy time of one frame per mode, by kernel."""
    from torch.profiler import ProfilerActivity, profile
    mask, depth = scenes["sparse"]
    out = {}
    for mode in VARIANTS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fns[mode](mask, depth, CX, CY, F, model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = []
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels.append((ev.self_device_time_total / 1e3, ev.count,
                                ev.key))
        kernels.sort(reverse=True)
        busy = sum(k[0] for k in kernels)
        ours = {name.split("(")[0]: {"ms": ms, "count": n}
                for ms, n, name in kernels
                if name.split("(")[0].endswith(KERNEL_FUNCTIONS)}
        out[mode] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "kernel_launches": sum(k[1] for k in kernels),
            "ported_kernels": ours,
            "top": [{"ms": ms, "count": n, "name": name[:80]}
                    for ms, n, name in kernels[:10]]}
        log(f"profile {mode}/sparse {json.dumps(out[mode])}")
    return out


def _same_message(a: str, b: str, tol: float) -> bool:
    """Pixel fields equal, float fields within ``tol``."""
    pa, pb = a.split(","), b.split(",")
    return len(pa) == len(pb) and pa[:2] == pb[:2] and all(
        abs(float(x) - float(y)) <= tol for x, y in zip(pa[2:], pb[2:]))


def run_service(torch, dev, cfg, model, model_cpu, scenes):
    """Phase 5: the grasp service on the card."""
    from leafgrasp_tpu_torch.io.framelog import FrameLogReader
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.pipeline.visualizer import LeafVisualizer
    from leafgrasp_tpu_torch.utils.device import (host_reads,
                                                  reset_host_reads)

    frames = []
    for name, *_ in FAMILIES:
        mask, depth = scenes[name]
        for i in range(SERVICE_FRAMES_PER_FAMILY):
            frames.append((name, i, np.roll(mask, 3 * i, axis=1),
                           np.roll(depth, 3 * i, axis=1)))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "service.lflg")
    if os.path.exists(log_path):
        os.remove(log_path)

    def make(msgs, device=None, cnn=model, **kw):
        svc = GraspService(cfg, cnn=cnn, publish=msgs.append,
                           min_interval_s=0.0, device=device, **kw)
        svc.set_camera_params(default_projection())
        return svc

    def push(svc, stream):
        outs = []
        for stamp, (mask, depth) in enumerate(stream):
            svc.on_mask(mask, stamp_us=stamp)
            svc.on_depth(depth, stamp_us=stamp)
            outs.append(svc.process_pending(force=True))
        return outs

    stream = [(m, d) for _, _, m, d in frames]
    make([]).process_frame(*stream[0])            # warm-up, uncounted
    make([], hist_median=True).process_frame(*stream[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()

    sync_msgs, piped_msgs, replay_msgs = [], [], []
    svc = make(sync_msgs, record_path=log_path)
    t0 = time.perf_counter()
    sync_outs = push(svc, stream)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    svc.stop()
    reads = host_reads()
    if any(o is None or not o["found"] for o in sync_outs):
        raise RuntimeError("service: a frame was dropped or found no grasp")
    log(f"service frame bus: {'native' if svc.bus.is_native else 'python'}")
    log(f"service pipeline_depth=0: {len(stream)} frames in {sync_s:.3f} s, "
        f"{len(stream) / sync_s} frames/s, host reads per frame "
        f"{reads / len(stream)}")
    log(f"service stages {json.dumps(svc.stats()['stages'])}")
    log(svc.timer.report())

    piped = make(piped_msgs, pipeline_depth=2)
    t0 = time.perf_counter()
    outs = push(piped, stream)
    late = piped.flush()
    torch.cuda.synchronize()
    piped_s = time.perf_counter() - t0
    order = [o["frame_index"] for o in outs if o is not None] \
        + [o["frame_index"] for o in late]
    if outs[0] is not None or outs[1] is not None \
            or order != list(range(len(stream))):
        raise RuntimeError(f"service pipeline_depth=2: order {order}")
    log(f"service pipeline_depth=2: {len(stream)} frames in {piped_s:.3f} "
        f"s, {len(stream) / piped_s} frames/s")

    replay = make(replay_msgs)
    with FrameLogReader(log_path) as rd:
        if len(rd) != len(stream):
            raise RuntimeError(f"service log holds {len(rd)} frames, not "
                               f"{len(stream)}")
        for mask, depth, stamp in rd:
            replay.process_frame(np.array(mask), np.array(depth),
                                 mask_stamp=stamp)
    os.remove(log_path)
    if not (sync_msgs == piped_msgs == replay_msgs) \
            or len(sync_msgs) != len(stream):
        raise RuntimeError(f"service runs disagree: {sync_msgs} / "
                           f"{piped_msgs} / {replay_msgs}")
    log(f"phase 5: three service runs of {len(stream)} frames published "
        f"the same messages")

    hist_msgs = []
    hist_svc = make(hist_msgs, hist_median=True)
    hist_at = [k for k, (_, i, _, _) in enumerate(frames)
               if i < SERVICE_HIST_FRAMES_PER_FAMILY]
    push(hist_svc, [stream[k] for k in hist_at])
    torch.cuda.synchronize()
    counts = launch_counts()
    for msg, k in zip(hist_msgs, hist_at):
        if not _same_message(msg, sync_msgs[k], SERVICE_FLOAT_TOL):
            raise RuntimeError(f"service hist_median frame {k}: {msg} != "
                               f"default {sync_msgs[k]}")
    if len(hist_msgs) != len(hist_at):
        raise RuntimeError("service hist_median: a frame published nothing")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"the service launched no {missing}")
    log(f"phase 5: the hist_median service published the default's "
        f"messages on {len(hist_at)} frames; launches {json.dumps(counts)}")

    cpu_msgs = []
    cpu = make(cpu_msgs, device="cpu", cnn=model_cpu)
    for k, (name, i, mask, depth) in enumerate(frames):
        if i != 0:
            continue
        cpu.process_frame(mask, depth)
        same = sync_msgs[k] == cpu_msgs[-1]
        log(f"service {name}: card {sync_msgs[k]} cpu {cpu_msgs[-1]} "
            f"identical {same}")
        if not _same_message(sync_msgs[k], cpu_msgs[-1], SERVICE_FLOAT_TOL):
            raise RuntimeError(f"service {name}: card message "
                               f"{sync_msgs[k]} != cpu {cpu_msgs[-1]}")

    res = sync_outs[0]["result"]
    tall = [i + 1 for i, t in enumerate(res.leaf_selection.is_tall) if t]
    image = LeafVisualizer().render(stream[0][0], int(res.leaf_id),
                                    res.grasp_uv, res.grasp_xyz,
                                    res.pre_grasp_xyz, tall_leaves=tall)
    if image.shape != (H, W, 3) or not image.any():
        raise RuntimeError(f"visualizer rendered {image.shape}")
    log("phase 5: card messages match the CPU service; visualizer rendered")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    try:
        from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG,
                                                GraspScoringConfig,
                                                ModelConfig)
        from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
        from leafgrasp_tpu_torch.kernels.build import load_library
        from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                          init_random_)
        from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    except ImportError as exc:
        print(f"leafgrasp_tpu_torch not importable: {exc}", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off")

    t0 = time.perf_counter()
    load_library(verbose=True)
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    scenes = {name: make_leaf_scene(H, W, num_leaves=n, seed=seed,
                                    margin=margin)
              for name, n, seed, margin in FAMILIES}
    with torch.no_grad():
        records = check_kernels(torch, dev, *scenes["sparse"])
    log("phase 2: every kernel matches its plain version")

    model_cpu = init_random_(GraspPointCNN(ModelConfig()), seed=0).eval()
    model = copy.deepcopy(model_cpu).to(dev).eval()
    cfgs = {mode: DEFAULT_CONFIG.replace(
        grasp=GraspScoringConfig(isolation_context=mode)) for mode in MODES}
    fns = {name: make_frame_fn(cfgs[iso], with_cnn=True, hist_median=hist)
           for name, (iso, hist) in VARIANTS.items()}
    for mode in VARIANTS:    # warm-up (allocator, cuDNN plans), uncounted
        fns[mode](*scenes["sparse"], CX, CY, F, model)
    results, counts, reads, frame_ms = run_frames(torch, dev, fns, model,
                                                  scenes)
    n_frames = len(VARIANTS) * len(FAMILIES) * FRAMES_PER_CELL
    log(f"phase 3: {n_frames} frames; launches {json.dumps(counts)}; host "
        f"reads {reads} ({reads / n_frames:.1f} per frame)")
    for key, val in frame_ms.items():
        log(f"frame_ms {key} {json.dumps(val)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"the main path launched no {missing}")
    cross_check(results, cfgs, model_cpu, scenes)
    log("phase 3: card frames match the CPU path")

    profile_frames(torch, fns, model, scenes)
    log("phase 4: profiled")

    service_counts = run_service(torch, dev, cfgs[SERVICE_MODE], model,
                                 model_cpu, scenes)

    for rec in records:
        rec["launches_frames"] = counts[rec["name"]]
        rec["launches_service"] = service_counts[rec["name"]]
        rec["launches"] = counts[rec["name"]] + service_counts[rec["name"]]
    log(card_line())
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
