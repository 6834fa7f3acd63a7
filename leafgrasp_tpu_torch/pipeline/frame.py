"""End-to-end frame pipeline, PyTorch port of
leafgrasp_tpu/pipeline/frame.py: (mask, depth, camera) -> leaf id,
grasp pixel, 3D grasp and pre-grasp.

The steps are the JAX package's: leaf selection, the score maps (fused
scoring kernel), spaced top-k, one batched CNN forward (attention
kernel), fusion, 3D lift and the pre-grasp march. PyTorch runs them
eagerly on the chosen device; the data-dependent choices that JAX
traces as ``lax.cond``/``while_loop`` are Python branches on scalars
read back through ``utils.device.host_read``, which counts them.

``select_grasp`` runs as six consecutive spans (``utils.profiler.span``:
``upload``, ``leaf_select``, ``score_maps``, ``candidates``, ``cnn``,
``lift``), timed into the caller's bound ``StageTimer``, if any.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from leafgrasp_tpu_torch.geometry.grasp_scorer import compute_grasp_scores
from leafgrasp_tpu_torch.geometry.leaf_scorer import (LeafSelection,
                                                      select_optimal_leaf)
from leafgrasp_tpu_torch.geometry.lift3d import (lift_to_3d,
                                                 lift_to_3d_with_cloud,
                                                 pre_grasp_point)
from leafgrasp_tpu_torch.geometry.patches import assemble_cnn_inputs
from leafgrasp_tpu_torch.models.grasp_cnn import ml_scores_from_logits
from leafgrasp_tpu_torch.ops.topk import Candidates, topk_min_distance
from leafgrasp_tpu_torch.pipeline.fusion import FusionResult, fuse_candidates
from leafgrasp_tpu_torch.utils.device import resolve_device
from leafgrasp_tpu_torch.utils.profiler import span

__all__ = ["FrameResult", "select_grasp", "make_frame_fn"]


class FrameResult(NamedTuple):
    found: torch.Tensor          # bool: a leaf was selected
    degenerate: torch.Tensor     # bool: valid region empty (treat as miss)
    leaf_id: torch.Tensor        # int32 (0 if none)
    grasp_uv: torch.Tensor       # (2,) int32 pixel (u, v)
    grasp_xyz: torch.Tensor      # (3,) float32 camera-frame metres
    pre_grasp_xyz: torch.Tensor  # (3,) float32
    ml_used: torch.Tensor        # bool
    candidates: Candidates
    fusion: FusionResult
    leaf_selection: LeafSelection


def _scalar(v, device) -> torch.Tensor:
    """A camera scalar as a float32 0-dim tensor (JAX traces them as f32)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(np.float32(v), device=device)


@torch.no_grad()
def select_grasp(mask_ids, depth, camera_cx, camera_cy, f_norm,
                 cnn=None, cfg: PipelineConfig = DEFAULT_CONFIG,
                 points=None, cnn_norm_stats=None,
                 device=None, hist_median: bool = False) -> FrameResult:
    """Full grasp selection for one frame.

    mask_ids : (H, W) integer instance map (numpy or tensor)
    depth    : (H, W) float32 metric depth
    cnn      : optional GraspPointCNN (eval mode, on ``device``); None
        runs CV-only, as the reference does without a checkpoint
    points   : optional (H, W, 3) organized cloud for the 1 cm 3D check
    cnn_norm_stats : optional stats dict -> train-consistent patch
        normalization; None -> the reference per-patch min-max
    device   : None means CUDA (raises if absent)
    hist_median : take the per-leaf median depths from the two-level
        histogram (ops/median.py) instead of the bisection; they agree
        within its 1e-5 m envelope, not bit for bit
    """
    with span("upload"):
        dev = resolve_device(device)
        mask_ids = torch.as_tensor(mask_ids).to(device=dev,
                                                dtype=torch.int32)
        depth = torch.as_tensor(depth).to(device=dev, dtype=torch.float32)
        cx, cy, f = (_scalar(v, dev) for v in (camera_cx, camera_cy,
                                                f_norm))

    with span("leaf_select"):
        sel = select_optimal_leaf(mask_ids, depth, cx, cy, f, cfg=cfg.leaf,
                                  frame=cfg.frame, hist_median=hist_median)

    with span("score_maps"):
        leaf = mask_ids == sel.best_leaf_id
        all_mask = mask_ids > 0
        # isolation feeds only the CNN patch channels: CV-only skips its
        # fields
        scores = compute_grasp_scores(leaf, all_mask, depth, cx, cy, f,
                                      cfg=cfg.grasp,
                                      skip_isolation=cnn is None)

    with span("candidates"):
        cand = topk_min_distance(scores.traditional_score,
                                 scores.valid_region, k=cfg.grasp.top_k,
                                 min_distance=cfg.grasp.min_candidate_distance)

    with span("cnn"):
        ml = None
        if cnn is not None:
            feats = assemble_cnn_inputs(depth, leaf, scores, cand.x, cand.y,
                                        cfg.fusion.patch_size,
                                        norm_stats=cnn_norm_stats)
            ml = ml_scores_from_logits(cnn(feats),
                                       cfg.fusion.score_spread_scale)

    with span("lift"):
        fusion = fuse_candidates(
            cand.score, torch.zeros_like(cand.score) if ml is None else ml,
            cand.accepted, ml is not None, cfg.fusion)
        u = cand.x[fusion.best_index]
        v = cand.y[fusion.best_index]
        uf, vf = u.to(torch.float32), v.to(torch.float32)
        d = depth[v.to(torch.int64), u.to(torch.int64)]
        if points is None:
            grasp_xyz = lift_to_3d(uf, vf, d, cx, cy, f)
        else:
            pts = torch.as_tensor(points).to(device=dev, dtype=torch.float32)
            grasp_xyz = lift_to_3d_with_cloud(
                uf, vf, d, pts, cx, cy, f,
                threshold_m=cfg.pregrasp.cloud_threshold_m)
        pre = pre_grasp_point(grasp_xyz, leaf, cx, cy, f, cfg=cfg.pregrasp)
        return FrameResult(
            found=sel.found & cand.accepted[0],
            degenerate=~(cand.score[0] > 0),
            leaf_id=sel.best_leaf_id,
            grasp_uv=torch.stack([u, v]),
            grasp_xyz=grasp_xyz,
            pre_grasp_xyz=pre.point,
            ml_used=fusion.ml_used,
            candidates=cand,
            fusion=fusion,
            leaf_selection=sel,
        )


def make_frame_fn(cfg: PipelineConfig = DEFAULT_CONFIG,
                  with_cnn: bool = False, device=None, norm_stats=None,
                  hist_median: bool = False):
    """Build the frame function for ``device`` (None means CUDA; raises
    if CUDA is absent, there is no fallback to the CPU).

    Returns ``fn(mask, depth, cx, cy, f)`` or, with ``with_cnn``,
    ``fn(mask, depth, cx, cy, f, cnn)`` where ``cnn`` is a
    GraspPointCNN in eval mode on the same device. ``norm_stats`` is
    required iff ``cfg.fusion.patch_normalization == "train_stats"``.
    ``hist_median`` is handed to ``select_grasp``.
    """
    dev = resolve_device(device)
    if cfg.fusion.patch_normalization not in ("reference_minmax",
                                              "train_stats"):
        raise ValueError(
            f"unknown patch_normalization "
            f"{cfg.fusion.patch_normalization!r}; expected "
            f"'reference_minmax' or 'train_stats'")
    corrected = cfg.fusion.patch_normalization == "train_stats"
    if corrected and with_cnn and norm_stats is None:
        raise ValueError("patch_normalization='train_stats' needs the "
                         "checkpoint's norm_stats")
    stats = None
    if corrected and norm_stats is not None:
        stats = {k: torch.as_tensor(np.asarray(norm_stats[k], np.float32),
                                    device=dev)
                 for k in ("depth_mean", "depth_std", "score_mean",
                           "score_std")}

    if not with_cnn:
        def fn(mask_ids, depth, cx, cy, f):
            return select_grasp(mask_ids, depth, cx, cy, f, cfg=cfg,
                                device=dev, hist_median=hist_median)
        return fn

    def fn_cnn(mask_ids, depth, cx, cy, f, cnn):
        return select_grasp(mask_ids, depth, cx, cy, f, cnn=cnn, cfg=cfg,
                            cnn_norm_stats=stats, device=dev,
                            hist_median=hist_median)
    return fn_cnn
