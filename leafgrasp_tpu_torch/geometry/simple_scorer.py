"""Legacy v2-generation leaf selection, PyTorch port of
leafgrasp_tpu/geometry/simple_scorer.py (reference leaf_grasp_node_v2.py).

The reference's first live GPU node scored leaves with three simple
metrics before the Pareto pipeline existed: height = 1/mean_depth,
isolation = 1/mean(21x21-box count of other-leaf pixels over the leaf),
flatness = 1/var(surface normal angles from Sobel depth gradients), each
clamp-normalized, blended 0.35/0.35/0.30 with a 3500 px area gate and a
0.7 m depth gate; the published grasp point was the winning leaf's
centroid (leaf_grasp_node_v2.py:38-91,198-313,474-481).

Kept for capability parity with the reference's node lineage; the
production path is geometry.leaf_scorer + geometry.grasp_scorer. The
per-leaf means are float64 segment sums rounded once to float32
(ops/components.py), so they may differ from the JAX package's float32
sums by a few ulps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from leafgrasp_tpu_torch.ops.components import _segment_sum, leaf_stats
from leafgrasp_tpu_torch.ops.conv import (separable_conv2d_reflect,
                                          sobel_gradients)

__all__ = ["SimpleSelection", "select_leaf_simple"]


class SimpleSelection(NamedTuple):
    best_leaf_id: torch.Tensor    # int32, 0 if none
    found: torch.Tensor
    centroid_uv: torch.Tensor     # (2,) int32: the v2 "grasp point"
    scores: torch.Tensor          # (L, 3) [height, isolation, flatness]
    total: torch.Tensor           # (L,)
    valid: torch.Tensor           # (L,)


def _per_leaf_mean(field, ids, max_leaves):
    """Mean of ``field`` over each leaf id's pixels; ``ids`` is the
    int64 map already clipped to [0, max_leaves + 1]."""
    num = max_leaves + 2
    sums = _segment_sum(ids, field.to(torch.float64), num)
    counts = _segment_sum(ids, torch.ones_like(field, dtype=torch.float64),
                          num)
    sl = slice(1, max_leaves + 1)
    return sums[sl].to(torch.float32) \
        / torch.clamp(counts[sl], min=1.0).to(torch.float32)


def _normalize(score, valid):
    """Divide by the largest valid score and clamp to [0, 1]."""
    top = torch.where(valid, score, torch.zeros_like(score)).max()
    return torch.clamp(score / torch.clamp(top, min=1e-6), 0.0, 1.0)


@torch.no_grad()
def select_leaf_simple(mask_ids: torch.Tensor, depth: torch.Tensor,
                       max_leaves: int = 16, min_area: int = 3500,
                       depth_threshold: float = 0.7,
                       kernel_size: int = 21) -> SimpleSelection:
    mask_ids = mask_ids.to(torch.int32)
    depth = depth.to(torch.float32)
    h, w = mask_ids.shape
    ids = torch.clamp(mask_ids, 0, max_leaves + 1).to(torch.int64)

    stats = leaf_stats(mask_ids, depth, max_leaves, w / 2.0, h / 2.0, 1.0)
    valid = stats.present & (stats.area >= min_area) \
        & (stats.mean_depth < depth_threshold)

    # height score: closer leaves win (leaf_grasp_node_v2.py:200-214)
    height = _normalize(1.0 / torch.clamp(stats.mean_depth, min=1e-6), valid)

    # isolation: inverse mean count of leaf pixels in a 21x21 box, over
    # the box's count of pixels
    all_leaves = (mask_ids > 0).to(torch.float32)
    box = (1.0,) * kernel_size
    crowd = separable_conv2d_reflect(all_leaves, box, box)
    own = separable_conv2d_reflect(torch.ones_like(all_leaves), box, box)
    per_leaf_crowd = _per_leaf_mean(crowd / own, ids, max_leaves)
    isolation = _normalize(1.0 / torch.clamp(per_leaf_crowd, min=1e-3),
                           valid)

    # flatness: inverse variance of surface-normal angle
    dx, dy = sobel_gradients(depth)
    angle = torch.atan2(torch.sqrt(dx * dx + dy * dy),
                        torch.ones_like(dx))
    mean_a = _per_leaf_mean(angle, ids, max_leaves)
    mean_a2 = _per_leaf_mean(angle * angle, ids, max_leaves)
    var = torch.clamp(mean_a2 - mean_a ** 2, min=1e-9)
    flatness = _normalize(1.0 / var, valid)

    scores = torch.stack([height, isolation, flatness], dim=-1)
    total = 0.35 * height + 0.35 * isolation + 0.30 * flatness
    masked = torch.where(valid, total,
                         torch.full_like(total, float("-inf")))
    best = torch.argmax(masked)
    found = valid.any()
    best_id = torch.where(found, best.to(torch.int32) + 1,
                          torch.zeros((), dtype=torch.int32,
                                      device=total.device))
    u = stats.centroid_x[best].to(torch.int32)
    v = stats.centroid_y[best].to(torch.int32)
    return SimpleSelection(best_leaf_id=best_id, found=found,
                           centroid_uv=torch.stack([u, v]), scores=scores,
                           total=total, valid=valid)
