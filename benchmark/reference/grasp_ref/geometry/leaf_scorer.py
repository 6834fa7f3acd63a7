# Frozen copy of leafgrasp_tpu_torch/geometry/leaf_scorer.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Pareto-optimal leaf selection, PyTorch port of
leafgrasp_tpu/geometry/leaf_scorer.py (reference leaf_scorer.py:25-199):
tall-leaf split on median depth, SDF-extrema clutter score, exponential
3D-distance score, border-contact visibility score, Pareto front,
weighted argmax over padded per-slot vectors (slot i <-> leaf id i+1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.grasp_ref.config import FrameConfig, LeafSelectionConfig
from benchmark.reference.grasp_ref.ops.components import LeafStats, leaf_stats
from benchmark.reference.grasp_ref.ops.edt import edt_max_argmax
from benchmark.reference.grasp_ref.ops.pareto import pareto_mask

__all__ = ["LeafSelection", "select_optimal_leaf", "leaf_choice_from_stats"]


class LeafSelection(NamedTuple):
    best_leaf_id: torch.Tensor   # int32 scalar; 0 = no valid leaf
    found: torch.Tensor          # bool scalar
    scores: torch.Tensor         # (L, 3) [clutter, distance, visibility]
    weighted: torch.Tensor       # (L,)
    candidate: torch.Tensor      # (L,) bool area/validity filter
    is_tall: torch.Tensor        # (L,) bool
    on_front: torch.Tensor       # (L,) bool
    stats: LeafStats


def select_optimal_leaf(mask_ids: torch.Tensor, depth: torch.Tensor,
                        camera_cx, camera_cy, f_norm,
                        cfg: LeafSelectionConfig = LeafSelectionConfig(),
                        frame: FrameConfig = FrameConfig(),
                        hist_median: bool = False) -> LeafSelection:
    """Select the optimal leaf id from an instance map + depth frame.
    ``hist_median`` is handed to ``leaf_stats`` (medians from the
    histogram kernel instead of the bisection)."""
    h, w = mask_ids.shape
    stats = leaf_stats(mask_ids, depth, frame.max_leaves, camera_cx,
                       camera_cy, f_norm, hist_median=hist_median)
    # global SDF extrema (leaf_scorer.py:66-71): argmin is the first
    # foreground pixel, argmax the background pixel farthest from any leaf
    fg = mask_ids > 0
    amin = torch.argmax(fg.reshape(-1).to(torch.int32))
    _, amax = edt_max_argmax(fg)
    amax = amax.to(torch.int64)
    min_y, min_x = (amin // w).to(torch.float32), (amin % w).to(torch.float32)
    max_y, max_x = (amax // w).to(torch.float32), (amax % w).to(torch.float32)
    return leaf_choice_from_stats(stats, min_x, min_y, max_x, max_y, h, w,
                                  f_norm, cfg)


def leaf_choice_from_stats(stats: LeafStats, min_x, min_y, max_x, max_y,
                           h: int, w: int, f_norm,
                           cfg: LeafSelectionConfig) -> LeafSelection:
    """Per-leaf choice from the stats and the SDF extrema."""
    present = stats.present
    dev = present.device
    n_present = torch.clamp(present.sum(), min=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    depth_mean = torch.where(present, stats.median_depth, zero).sum() \
        / n_present
    is_tall = present & (stats.median_depth < depth_mean)
    candidate = present & (stats.area >= cfg.min_leaf_area)

    dist_to_min = torch.sqrt((stats.centroid_x - min_x) ** 2
                             + (stats.centroid_y - min_y) ** 2)
    dist_to_max = torch.sqrt((stats.centroid_x - max_x) ** 2
                             + (stats.centroid_y - max_y) ** 2)
    total = dist_to_min + dist_to_max
    clutter = torch.where(total > 0,
                          dist_to_min / torch.clamp(total, min=1e-30), zero)

    mean_distance = stats.mean_depth * stats.mean_ray_norm / f_norm
    distance_score = torch.exp(-mean_distance / cfg.distance_scale_m)

    center_x, center_y = w / 2.0, h / 2.0
    max_dist = torch.sqrt(torch.tensor(center_x ** 2 + center_y ** 2,
                                       dtype=torch.float32, device=dev))
    dist_center = torch.sqrt((stats.centroid_x - center_x) ** 2
                             + (stats.centroid_y - center_y) ** 2)
    visibility = torch.where(stats.border_contact, zero,
                             1.0 - dist_center / max_dist)
    scores = torch.stack([clutter, distance_score, visibility], dim=-1)

    tall_cand = candidate & is_tall
    group = torch.where(tall_cand.any(), tall_cand, candidate)
    front = pareto_mask(scores, group)
    front = torch.where(front.any(), front, group)

    # the weighted sum in true f32 (the JAX matmul runs at HIGHEST
    # precision: near-tied leaves must not flip)
    weighted = (scores[:, 0] * cfg.clutter_weight
                + scores[:, 1] * cfg.distance_weight
                + scores[:, 2] * cfg.visibility_weight)
    masked = torch.where(front, weighted,
                         torch.full_like(weighted, float("-inf")))
    best_slot = torch.argmax(masked)
    found = candidate.any()
    best_leaf_id = torch.where(found, best_slot.to(torch.int32) + 1,
                               torch.zeros((), dtype=torch.int32,
                                           device=dev))
    return LeafSelection(best_leaf_id=best_leaf_id, found=found,
                         scores=scores, weighted=weighted,
                         candidate=candidate, is_tall=is_tall,
                         on_front=front, stats=stats)
