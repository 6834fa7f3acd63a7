# Frozen copy of leafgrasp_tpu_torch/geometry/patches.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Batched 9-channel patch assembly for CNN scoring, PyTorch port of
leafgrasp_tpu/geometry/patches.py (grasp_point_selector.py:59-143,
392-445): one clamped-index gather (clamping == the reference's
edge-replicate padding), then the reference's per-patch min-max
(``reference_minmax``) or the checkpoint's training z-score
(``train_stats``).

Channel order: 0 depth, 1 leaf mask (raw), 2..8 the 7 score channels.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.geometry.grasp_scorer import GraspScores

__all__ = ["extract_patches", "assemble_cnn_inputs",
           "normalize_patch_batch", "normalize_patch_batch_train_stats"]


def extract_patches(maps: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    patch_size: int = 32) -> torch.Tensor:
    """Gather (C, H, W) maps at K centers -> (K, C, P, P); window rows
    y - P/2 .. y + P/2 - 1, indices clamped to the frame."""
    _, h, w = maps.shape
    offs = torch.arange(patch_size, device=maps.device) - patch_size // 2
    rows = torch.clamp(ys.to(torch.int64)[:, None] + offs[None, :], 0, h - 1)
    cols = torch.clamp(xs.to(torch.int64)[:, None] + offs[None, :], 0, w - 1)
    return maps[:, rows[:, :, None], cols[:, None, :]].permute(1, 0, 2, 3)


def _minmax(p: torch.Tensor) -> torch.Tensor:
    """Min-max over the last two axes; identity for constant patches."""
    lo = p.amin(dim=(-2, -1), keepdim=True)
    hi = p.amax(dim=(-2, -1), keepdim=True)
    return torch.where(hi > lo, (p - lo) / torch.clamp(hi - lo, min=1e-30),
                       p)


def normalize_patch_batch(patches: torch.Tensor) -> torch.Tensor:
    """(K, 9, P, P) raw patches -> (K, P, P, 9) NHWC: depth and the score
    channels per-patch min-maxed, mask raw."""
    normed = torch.cat([_minmax(patches[:, :1]), patches[:, 1:2],
                        _minmax(patches[:, 2:])], dim=1)
    return normed.permute(0, 2, 3, 1).contiguous()


def normalize_patch_batch_train_stats(patches: torch.Tensor,
                                      norm_stats) -> torch.Tensor:
    """(K, 9, P, P) raw patches -> NHWC z-scored with the training stats
    (scalar depth z-score, per-channel score z-score, mask raw)."""
    dev = patches.device

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    eps = 1e-6
    depth_n = (patches[:, 0] - t(norm_stats["depth_mean"])) \
        / torch.clamp(t(norm_stats["depth_std"]), min=eps)
    sm = t(norm_stats["score_mean"]).reshape(1, 7, 1, 1)
    ss = torch.clamp(t(norm_stats["score_std"]).reshape(1, 7, 1, 1),
                     min=eps)
    score_n = (patches[:, 2:] - sm) / ss
    normed = torch.cat([depth_n[:, None], patches[:, 1:2], score_n], dim=1)
    return normed.permute(0, 2, 3, 1).contiguous()


def assemble_cnn_inputs(depth: torch.Tensor, leaf_mask: torch.Tensor,
                        scores: GraspScores, xs: torch.Tensor,
                        ys: torch.Tensor, patch_size: int = 32,
                        norm_stats=None) -> torch.Tensor:
    """(K, P, P, 9) NHWC feature batch for GraspPointCNN."""
    stack = torch.cat([depth.to(torch.float32)[None],
                       leaf_mask.to(torch.float32)[None],
                       scores.stacked_channels()], dim=0)       # (9, H, W)
    patches = extract_patches(stack, xs, ys, patch_size)
    if norm_stats is not None:
        return normalize_patch_batch_train_stats(patches, norm_stats)
    return normalize_patch_batch(patches)
