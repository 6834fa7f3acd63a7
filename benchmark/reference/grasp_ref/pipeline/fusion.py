# Frozen copy of leafgrasp_tpu_torch/pipeline/fusion.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Confidence-weighted CV (+) ML score fusion, PyTorch port of
leafgrasp_tpu/pipeline/fusion.py (grasp_point_selector.py:205-237):
ml_conf = 1 - |ml - 0.5| * 2, w = min(cap, ml_conf * scale),
combined = (1 - w) * trad + w * ml; the fused winner replaces candidate
0 only on strict improvement over its traditional score."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.grasp_ref.config import MLFusionConfig

__all__ = ["FusionResult", "fuse_candidates"]


class FusionResult(NamedTuple):
    best_index: torch.Tensor     # int64 index into the candidate arrays
    best_score: torch.Tensor     # float32
    ml_used: torch.Tensor        # bool
    combined: torch.Tensor       # (K,)
    ml_weight: torch.Tensor      # (K,)


def fuse_candidates(trad_scores: torch.Tensor, ml_scores: torch.Tensor,
                    accepted: torch.Tensor, use_ml: bool,
                    cfg: MLFusionConfig = MLFusionConfig()) -> FusionResult:
    """trad/ml: (K,) float32; accepted: (K,) bool. ``use_ml`` mirrors
    ``ml_predictor is not None`` (grasp_point_selector.py:210)."""
    trad = trad_scores.to(torch.float32)
    ml = ml_scores.to(torch.float32)
    accepted = accepted.to(torch.bool)
    ml_conf = 1.0 - torch.abs(ml - 0.5) * 2.0
    ml_weight = torch.clamp(ml_conf * cfg.ml_conf_scale,
                            max=cfg.ml_weight_cap)
    combined = (1.0 - ml_weight) * trad + ml_weight * ml
    do_ml = bool(use_ml) & (accepted.sum() > 1)
    masked = torch.where(accepted, combined,
                         torch.full_like(combined, float("-inf")))
    best_idx = torch.argmax(masked)
    baseline = trad[0]
    use_fused = do_ml & (masked[best_idx] > baseline)
    index = torch.where(use_fused, best_idx, torch.zeros_like(best_idx))
    score = torch.where(use_fused, masked[best_idx], baseline)
    return FusionResult(best_index=index, best_score=score,
                        ml_used=use_fused, combined=combined,
                        ml_weight=ml_weight)
