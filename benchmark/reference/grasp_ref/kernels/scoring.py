# Frozen copy of leafgrasp_tpu_torch/kernels/scoring.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
# The kernel wrapper always takes its plain PyTorch version.
"""Fused per-pixel grasp scoring: the kernel wrapper and its plain
version.

``fused_score_maps`` maps the leaf's distance fields, depth-gradient
magnitude, leaf mask and stem mask to the 7 score maps, the traditional
score and the valid mask (grasp_point_selector.py:256-288, 502-701).
It replaces the TPU kernel ``fused_score_maps``
(leafgrasp_tpu/ops/pallas_scoring.py:130); the kernel source, with its
bound and design, is ``csrc/scoring.cu``. The plain version composes
the unfused maps of geometry/grasp_scorer.py (``sdf_score_map`` ...
``valid_region_mask``, ported from the JAX package's, which it holds
its own kernel against); the two agree to ~1e-6 (f32 rounding of
algebraically equal forms), and the valid mask exactly.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference.grasp_ref.config import GraspScoringConfig
from benchmark.reference.grasp_ref.kernels import LAUNCHES

__all__ = ["fused_score_maps", "fused_score_maps_plain"]


def _pixel_grids(h: int, w: int, device, row0=0):
    """(ys, xs) float32 (H, W) grids; ``row0`` offsets rows to frame
    coordinates."""
    ys = (row0 + torch.arange(h, device=device, dtype=torch.float32)
          )[:, None].expand(h, w)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :] \
        .expand(h, w)
    return ys, xs


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def fused_score_maps_plain(din, dout, dclose, dwide, grad_mag, leaf_mask,
                           stem, camera_cx, camera_cy, f_norm, angle,
                           angle_valid,
                           cfg: GraspScoringConfig = GraspScoringConfig(),
                           row0=0, frame_height: int | None = None,
                           max_sdf=None, max_close=None, max_wide=None):
    """Plain PyTorch version: the unfused maps of
    geometry/grasp_scorer.py, composed as the JAX package composes its
    own. Returns (sdf, approach, flatness, isolation, distance,
    accessibility, stem, traditional, valid)."""
    from benchmark.reference.grasp_ref.geometry import grasp_scorer as gs
    from benchmark.reference.grasp_ref.ops.pca import Orientation

    dev = din.device
    m = leaf_mask.to(torch.bool)
    stem = stem.to(torch.float32)
    angle = _f32(angle, dev)
    orient = Orientation(angle=angle, major_axis=angle, minor_axis=angle,
                         center=angle, valid=angle_valid)
    sdf_score = gs.sdf_score_map(m, camera_cx, camera_cy, cfg, din, dout,
                                 row0, max_sdf, orient)
    approach = gs.approach_score_map(m, camera_cx, camera_cy, f_norm, row0)
    # flatness (grasp_point_selector.py:635-657)
    flatness = torch.exp(-grad_mag * cfg.flatness_gradient_scale)
    isolation = gs.isolation_score_map(m, None, cfg, dclose, dwide, row0,
                                       frame_height, max_close, max_wide)
    distance = din * m.to(torch.float32)
    accessibility = gs.accessibility_score_map(m, camera_cx, camera_cy, cfg,
                                               row0, frame_height)
    traditional = gs.combine_traditional(approach, sdf_score, flatness,
                                         accessibility, stem, cfg)
    valid = gs.valid_region_mask(distance, m, stem, cfg)
    return (sdf_score, approach, flatness, isolation, distance,
            accessibility, stem, traditional, valid)


@functools.lru_cache(maxsize=16)
def _weights(cfg: GraspScoringConfig, device: torch.device) -> torch.Tensor:
    """Config weights in the kernel's W_* layout (csrc/scoring.cu)."""
    vals = [cfg.optimal_edge_distance, cfg.sdf_interior_weight,
            cfg.sdf_alignment_weight, cfg.sdf_raw_weight,
            cfg.flatness_gradient_scale, cfg.isolation_close_weight,
            cfg.isolation_wide_weight, cfg.height_pref_top,
            cfg.height_pref_bottom - cfg.height_pref_top,
            cfg.access_distance_weight, cfg.access_direction_weight,
            cfg.approach_weight, cfg.sdf_weight, cfg.flatness_weight,
            cfg.accessibility_weight, cfg.min_edge_distance,
            cfg.stem_penalty_cutoff]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def fused_score_maps(din, dout, dclose, dwide, grad_mag, leaf_mask, stem,
                     camera_cx, camera_cy, f_norm, angle, angle_valid,
                     cfg: GraspScoringConfig = GraspScoringConfig(),
                     row0=0, frame_height: int | None = None,
                     max_sdf=None, max_close=None, max_wide=None):
    """One-pass fused scoring of (H, W) fields; the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns the 9 maps in
    grasp_scorer order (sdf, approach, flatness, isolation, distance,
    accessibility, stem, traditional, valid)."""
    dev = din.device
    if dev.type in ("cpu", "cuda"):
        return fused_score_maps_plain(
            din, dout, dclose, dwide, grad_mag, leaf_mask, stem, camera_cx,
            camera_cy, f_norm, angle, angle_valid, cfg, row0, frame_height,
            max_sdf, max_close, max_wide)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h, w = din.shape
    fh = h if frame_height is None else frame_height
    fields = [din, dout, dclose, dwide, grad_mag,
              leaf_mask.to(torch.float32), stem.to(torch.float32)]
    for t in fields:
        if t.shape != (h, w) or t.device != dev:
            raise ValueError("fields must share one (H, W) shape and device")
        if t.dtype != torch.float32:
            raise ValueError("fields must be float32")
    fields = [t.contiguous() for t in fields]

    if max_sdf is None:
        max_sdf = (din - dout).abs().max()
    max_sdf = torch.clamp(_f32(max_sdf, dev), min=1e-30)
    if max_close is None:
        max_close = dclose.max()
    if max_wide is None:
        max_wide = dwide.max()
    angle = _f32(angle, dev)
    valid_a = torch.as_tensor(angle_valid, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sin_a = torch.where(valid_a, torch.sin(angle), zero)
    cos_a = torch.where(valid_a, torch.cos(angle), zero)
    scal = torch.stack([_f32(camera_cx, dev), _f32(camera_cy, dev),
                        _f32(f_norm, dev), sin_a, cos_a, max_sdf,
                        _f32(max_close, dev), _f32(max_wide, dev),
                        _f32(fh, dev), _f32(w, dev), _f32(row0, dev)])
    wt = _weights(cfg, dev)
    outs = [torch.empty((h, w), dtype=torch.float32, device=dev)
            for _ in range(8)]
    valid = torch.empty((h, w), dtype=torch.uint8, device=dev)
    lib = load_library()
    err = lib.fused_score_maps(
        *[t.data_ptr() for t in fields], scal.data_ptr(), wt.data_ptr(),
        h, w, *[o.data_ptr() for o in outs], valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "fused_score_maps")
    LAUNCHES["fused_score_maps"] += 1

    # reference fallback, as the JAX wrapper applies it outside its
    # kernel (pallas_scoring.py:209-223): no orientation -> alignment 1
    m, stem_f = fields[5], fields[6]
    opt = cfg.optimal_edge_distance
    fallback = (cfg.sdf_interior_weight
                * torch.exp(-((din - opt) ** 2) / (2.0 * opt ** 2))
                + cfg.sdf_alignment_weight * 1.0
                + cfg.sdf_raw_weight * (din - dout) / max_sdf) * m
    sdf_score = torch.where(valid_a, outs[0], fallback)
    trad = torch.where(
        valid_a, outs[7],
        (cfg.approach_weight * outs[1] + cfg.sdf_weight * sdf_score
         + cfg.flatness_weight * outs[2]
         + cfg.accessibility_weight * outs[5]) * (1.0 - stem_f))
    return (sdf_score, outs[1], outs[2], outs[3], outs[4], outs[5],
            outs[6], trad, valid.to(torch.bool))
