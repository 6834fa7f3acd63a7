"""Per-pixel grasp scoring, PyTorch port of
leafgrasp_tpu/geometry/grasp_scorer.py (reference
grasp_point_selector.py:256-288, 502-701).

The distance fields follow the JAX package exactly: one batched pass-1
scan, the interference pass-1 from ``dilated_vertical_dist_multi``, the
wide fields' maxima from ``edt_max_argmax_batch``, and the per-leaf
fields from ONE pass-2 on the leaf's bbox window in the smallest ladder
window that fits (else the banded sweep). The score maps come from the
fused scoring kernel (kernels/scoring.py), whose plain version is the
JAX package's unfused composition.

Isolation modes: ``union`` (default), ``union_half`` (the interference
fields at half resolution through ``edt_batch``, i.e. the row-banded
kernel), ``reference_self``, and the CV-only skip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from leafgrasp_tpu_torch.config import GraspScoringConfig
from leafgrasp_tpu_torch.kernels.scoring import fused_score_maps
from leafgrasp_tpu_torch.ops.conv import gradient_magnitude
from leafgrasp_tpu_torch.ops.edt import (directional_seed_dist_1d, edt,
                                        edt_batch, edt_max_argmax,
                                        edt_max_argmax_batch, exact_sqrt,
                                        nearest_seed_dist_1d, squared_edt,
                                        squared_edt_window,
                                        squared_edt_window_src)
from leafgrasp_tpu_torch.ops.morphology import (dilate,
                                                dilated_vertical_dist_multi,
                                                elliptical_kernel, erode)
from leafgrasp_tpu_torch.ops.pca import mask_orientation, min_area_rect
from leafgrasp_tpu_torch.utils.device import host_read

__all__ = ["GraspScores", "SCORE_CHANNELS", "compute_grasp_scores",
           "stem_penalty_map", "tip_penalty_map"]

# Channel order consumed by the CNN (grasp_point_selector.py:95-99).
SCORE_CHANNELS = ("sdf_score", "approach_score", "flatness_map",
                  "isolation_map", "distance_map", "accessibility_map",
                  "stem_penalty")


class GraspScores(NamedTuple):
    sdf_score: torch.Tensor
    approach_score: torch.Tensor
    flatness_map: torch.Tensor
    isolation_map: torch.Tensor
    distance_map: torch.Tensor
    accessibility_map: torch.Tensor
    stem_penalty: torch.Tensor
    traditional_score: torch.Tensor
    valid_region: torch.Tensor    # bool

    def stacked_channels(self) -> torch.Tensor:
        """(7, H, W) stack in CNN channel order."""
        return torch.stack([getattr(self, name) for name in SCORE_CHANNELS])


def tip_penalty_map(leaf_mask: torch.Tensor,
                    kernel_size: int = 15) -> torch.Tensor:
    """Tip-proximity penalty of the data-collection (teacher) selector
    (grasp_point_selector_bkp / grasp_point_selector.py:703-716; JAX
    ``tip_penalty_map``): 1 at the dilated tip bands, falling with the
    distance from them."""
    m = leaf_mask.to(torch.bool)
    k = elliptical_kernel(kernel_size)
    tips = m & ~erode(m, k)
    tip_area = dilate(tips, k) & m
    dist_from_tips = edt(tip_area)
    penalty = 1.0 - dist_from_tips / (dist_from_tips.max() + 1e-6)
    return penalty * m.to(torch.float32)


def stem_penalty_map(leaf_mask: torch.Tensor,
                     cfg: GraspScoringConfig) -> torch.Tensor:
    """Dilated bottom-third intersection (grasp_point_selector.py:688-701)."""
    m = leaf_mask.to(torch.bool)
    h, _ = m.shape
    rows = torch.arange(h, device=m.device)[:, None]
    bottom = rows >= (h - h // 3)
    stem = dilate(m & bottom, elliptical_kernel(cfg.stem_kernel)) & m
    return stem.to(torch.float32)


def _leaf_fields(g2s: torch.Tensor, m: torch.Tensor, bbox,
                 cfg: GraspScoringConfig, field_bound=None) -> torch.Tensor:
    """sqrt-EDTs of a (C, H, W) pass-1 stack, exact on the leaf: one
    pass-2 on the leaf's bbox in the smallest ladder window that holds it
    (zeros outside the window), else the banded sweep sized to the leaf.
    ``bbox`` = (any, r_lo, r_hi, c_lo, c_hi) host values."""
    any_m, r_lo, r_hi, c_lo, c_hi = bbox
    _, fh, fw = g2s.shape
    sizes = sorted({(min(s, fh), min(s, fw))
                    for s in cfg.leaf_windows if s > 0})
    pad = cfg.leaf_window_src_pad
    for hq, wq in sizes:
        if not (any_m and r_hi - r_lo < hq and c_hi - c_lo < wq):
            continue
        r0 = min(max(r_lo, 0), fh - hq)
        c0 = min(max(c_lo, 0), fw - wq)
        if (pad and field_bound is not None and wq + 2 * pad < fw
                and host_read(field_bound < pad)):
            blk = squared_edt_window_src(g2s, r0, c0, hq, wq, pad)
        else:
            blk = squared_edt_window(g2s, r0, c0, hq, wq)
        out = torch.zeros(g2s.shape, dtype=torch.float32, device=g2s.device)
        out[:, r0:r0 + hq, c0:c0 + wq] = exact_sqrt(blk)
        return out
    return torch.stack([exact_sqrt(squared_edt(None, g2=g2s[i],
                                               band_mask=m))
                        for i in range(g2s.shape[0])])


def _half_edt(inter: torch.Tensor) -> torch.Tensor:
    """EDT of an interference mask at half resolution: 2x2 any-pool,
    ``edt_batch``, pixel scale x2, nearest upsample, edge pad for odd
    sizes."""
    h, w = inter.shape
    hh, wh = h // 2, w // 2
    pooled = inter[:hh * 2, :wh * 2].reshape(hh, 2, wh, 2).any(dim=3) \
        .any(dim=1)
    d = edt_batch(pooled[None])[0] * 2.0
    up = d.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return torch.nn.functional.pad(up[None, None],
                                   (0, w - wh * 2, 0, h - hh * 2),
                                   mode="replicate")[0, 0]


def compute_grasp_scores(leaf_mask: torch.Tensor, all_mask: torch.Tensor,
                         depth: torch.Tensor, camera_cx, camera_cy, f_norm,
                         cfg: GraspScoringConfig = GraspScoringConfig(),
                         skip_isolation: bool = False) -> GraspScores:
    """All score maps + traditional score + valid region for one leaf.

    leaf_mask : (H, W) bool, the selected leaf
    all_mask  : (H, W) bool, union of all leaves (for isolation)
    depth     : (H, W) float32 metric depth
    camera_cx/cy, f_norm : float32 0-dim tensors on the fields' device
    """
    m = leaf_mask.to(torch.bool)
    mf = m.to(torch.float32)
    depth = depth.to(torch.float32)
    dev = m.device
    iso_mode = "skip" if skip_isolation else cfg.isolation_context
    if iso_mode not in ("union", "union_half", "reference_self", "skip"):
        raise ValueError(f"unknown isolation_context {iso_mode!r}")
    env_kw = {}
    if cfg.envelope_stride:
        env_kw["stride"] = cfg.envelope_stride
    if cfg.envelope_k:
        env_kw["k"] = cfg.envelope_k

    fh, fw = m.shape
    rows_any = m.any(dim=1)
    cols_any = m.any(dim=0)
    bbox_t = torch.stack([
        m.any().to(torch.int64),
        torch.argmax(rows_any.to(torch.int32)),
        fh - 1 - torch.argmax(rows_any.flip(0).to(torch.int32)),
        torch.argmax(cols_any.to(torch.int32)),
        fw - 1 - torch.argmax(cols_any.flip(0).to(torch.int32))])
    bbox = host_read(bbox_t)
    _, r_lo, r_hi, c_lo, c_hi = bbox
    # any leaf pixel is within half the bbox's smaller side of the exterior
    din_bound = torch.tensor(0.5 * min(r_hi - r_lo + 1, c_hi - c_lo + 1)
                             + 2.0, dtype=torch.float32, device=dev)

    if iso_mode == "union":
        other = all_mask.to(torch.bool) & ~m
        # one directional scan serves all three pass-1 seeds
        d3_up, d3_dn = directional_seed_dist_1d(
            torch.stack([~m, m, other]), axis=1)
        g = torch.minimum(d3_up[:2], d3_dn[:2]).to(torch.float32)
        g2 = g * g
        gc, gw = (x.to(torch.float32) for x in dilated_vertical_dist_multi(
            d3_up[2], d3_dn[2],
            (elliptical_kernel(cfg.isolation_close_kernel),
             elliptical_kernel(cfg.isolation_wide_kernel)),
            impl=cfg.dvd_impl))
        g2_close, g2_wide = gc * gc, gw * gw
        no_other = ~other.any()
        maxs, _ = edt_max_argmax_batch(
            torch.stack([g2[1], g2_close, g2_wide]),
            constant_field=torch.stack([~m.any(), no_other, no_other]),
            **env_kw)
        max_dout, close_max, wide_max = maxs[0], maxs[1], maxs[2]
        din, dclose, dwide = _leaf_fields(
            torch.stack([g2[0], g2_close, g2_wide]), m, bbox, cfg,
            field_bound=torch.maximum(din_bound,
                                      torch.maximum(close_max, wide_max)))
    else:
        g = nearest_seed_dist_1d(torch.stack([~m, m]), axis=1) \
            .to(torch.float32)
        g2 = g * g
        din = _leaf_fields(g2[:1], m, bbox, cfg, field_bound=din_bound)[0]
        max_dout, _ = edt_max_argmax(m, g2=g2[1], **env_kw)
    if iso_mode == "union_half":
        other = all_mask.to(torch.bool) & ~m
        dclose = _half_edt(dilate(other, elliptical_kernel(
            cfg.isolation_close_kernel)))
        dwide = _half_edt(dilate(other, elliptical_kernel(
            cfg.isolation_wide_kernel)))
        close_max = dclose.max()
        wide_max = dwide.max()
    elif iso_mode != "union":
        # reference_self: empty interference -> cv2 FLT_MAX field ->
        # normalized score 1 everywhere; skip: zero field -> score 0
        fill = 0.0 if skip_isolation else 1.0
        dclose = torch.full_like(din, fill)
        dwide = torch.full_like(din, fill)
        close_max = torch.full((), fill, dtype=torch.float32, device=dev)
        wide_max = close_max

    # max|sdf| = max(din inside, dist_outside outside): disjoint supports
    sdf_norm = torch.maximum(din.max(), max_dout)
    zeros_dout = torch.zeros_like(din)

    if cfg.orientation_source == "min_area_rect":
        o = min_area_rect(m)
    else:
        o = mask_orientation(m)

    grad_mag = gradient_magnitude(depth * mf, cfg.gaussian_kernel_size)
    stem = stem_penalty_map(m, cfg)
    (sdf, approach, flatness, isolation, distance, accessibility, stem_o,
     traditional, valid) = fused_score_maps(
        din, zeros_dout, dclose, dwide, grad_mag, mf, stem, camera_cx,
        camera_cy, f_norm, o.angle, o.valid, cfg=cfg, max_sdf=sdf_norm,
        max_close=close_max, max_wide=wide_max)
    return GraspScores(sdf_score=sdf, approach_score=approach,
                       flatness_map=flatness, isolation_map=isolation,
                       distance_map=distance,
                       accessibility_map=accessibility, stem_penalty=stem_o,
                       traditional_score=traditional, valid_region=valid)
