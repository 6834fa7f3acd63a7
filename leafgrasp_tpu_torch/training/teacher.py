"""Self-supervised teacher loop: CV pipeline labels -> training set,
PyTorch port of leafgrasp_tpu/training/teacher.py (reference
grasp_point_selector_bkp.py:63-160, SURVEY.md 3.5): erode the leaf mask
into a safe zone (21x21 ellipse, twice), score with the teacher blend
``(0.4 approach + 0.3 sdf + 0.2 flatness + 0.1 (1 - tip_penalty))
(1 - stem)`` in float32 in that order (so ``argmax`` ties resolve to the
JAX package's pixel), take the argmax as the positive label, and hand
every selection to the data collector (which adds rotations and
negatives).

The served path is the teacher: ``select_optimal_leaf`` and
``compute_grasp_scores`` run the port's kernels on the card.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from leafgrasp_tpu_torch.geometry.grasp_scorer import (GraspScores,
                                                       compute_grasp_scores,
                                                       tip_penalty_map)
from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
from leafgrasp_tpu_torch.ops.morphology import elliptical_kernel, erode
from leafgrasp_tpu_torch.pipeline.frame import _scalar
from leafgrasp_tpu_torch.training.data_collector import GraspDataCollector
from leafgrasp_tpu_torch.utils.device import host_read, resolve_device

__all__ = ["teacher_select", "collect_from_frames"]


def teacher_select(leaf_mask, all_mask, depth, camera_cx, camera_cy,
                   f_norm, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
                   ) -> Tuple[Optional[Tuple[int, int]], float, GraspScores]:
    """Teacher grasp point for one leaf on ``device`` (None means CUDA).

    Returns ((x, y), total_score, scores) or (None, 0.0, scores) when the
    eroded safe zone is empty (bkp:160-170 falls back to the centroid;
    we report None and let the caller decide).
    """
    dev = resolve_device(device)
    m = torch.as_tensor(leaf_mask).to(device=dev, dtype=torch.bool)
    all_m = torch.as_tensor(all_mask).to(device=dev, dtype=torch.bool)
    depth = torch.as_tensor(depth).to(device=dev, dtype=torch.float32)
    cx, cy, f = (_scalar(v, dev) for v in (camera_cx, camera_cy, f_norm))
    scores = compute_grasp_scores(m, all_m, depth, cx, cy, f, cfg=cfg.grasp)
    tip = tip_penalty_map(m)

    k = elliptical_kernel(21)
    safe = erode(erode(m, k), k)

    teacher_score = (0.4 * scores.approach_score
                     + 0.3 * scores.sdf_score
                     + 0.2 * scores.flatness_map
                     + 0.1 * (1.0 - tip)) * (1.0 - scores.stem_penalty)
    masked = torch.where(safe, teacher_score,
                         torch.full_like(teacher_score, -torch.inf))
    flat = masked.reshape(-1)
    idx = torch.argmax(flat)
    idx_v, value, inside = host_read(torch.stack([
        idx.to(torch.float64), flat[idx].to(torch.float64),
        safe.reshape(-1)[idx].to(torch.float64)]))
    if not inside:
        return None, 0.0, scores
    y, x = divmod(int(idx_v), m.shape[1])
    return (x, y), float(np.float32(value)), scores


def collect_from_frames(frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                        collector: GraspDataCollector,
                        camera_cx: float, camera_cy: float, f_norm: float,
                        cfg: PipelineConfig = DEFAULT_CONFIG) -> int:
    """Run leaf selection + teacher labeling over (mask, depth) frames on
    the collector's device, feeding every positive into the collector.
    Returns the number of frames used."""
    dev = collector.device
    cx, cy, f = (_scalar(v, dev) for v in (camera_cx, camera_cy, f_norm))
    used = 0
    for mask, depth in frames:
        mask_t = torch.as_tensor(mask).to(device=dev, dtype=torch.int32)
        depth_t = torch.as_tensor(depth).to(device=dev, dtype=torch.float32)
        sel = select_optimal_leaf(mask_t, depth_t, cx, cy, f, cfg=cfg.leaf,
                                  frame=cfg.frame)
        leaf_id, found = host_read(torch.stack([
            sel.best_leaf_id.to(torch.int64), sel.found.to(torch.int64)]))
        if not found:
            continue
        leaf = mask_t == leaf_id
        point, total, scores = teacher_select(
            leaf, mask_t > 0, depth_t, cx, cy, f, cfg, device=dev)
        if point is None:
            continue
        if collector.collect_sample(leaf, depth_t, scores, point, total):
            used += 1
    collector.save()
    return used
