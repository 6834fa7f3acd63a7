"""Hybrid VLA (+) geometric candidate selection.

Rebuild of vla_system/hybrid_selector.py with the confidence->weight
ladder (>0.8 -> 0.6 VLA, >0.5 -> 0.3, >0.2 -> 0.1, else geometric-only)
and min-max-normalized blending.

Public API note: the reference READMEs advertise a
``HybridGraspSelector`` class with ``select_grasp_point(image,
candidates)`` (reference README.md:65-70) while actually shipping
``HybridSelector.select_best_candidate`` -- this module provides BOTH,
with the documented name as the canonical entry point.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from leafgrasp_tpu_torch.vla.confidence import ConfidenceManager

__all__ = ["HybridSelector", "HybridGraspSelector",
           "confidence_weights", "selection_strategy"]

_LADDER = ((0.8, 0.6), (0.5, 0.3), (0.2, 0.1))


def confidence_weights(vla_confidence: float,
                       ladder=_LADDER) -> Dict[str, float]:
    vla_weight = 0.0
    for threshold, weight in ladder:
        if vla_confidence > threshold:
            vla_weight = weight
            break
    return {"vla": vla_weight, "geometric": 1.0 - vla_weight}


def selection_strategy(vla_confidence: float) -> str:
    if vla_confidence > 0.8:
        return "VLA_DOMINANT"
    if vla_confidence > 0.5:
        return "BALANCED"
    if vla_confidence > 0.2:
        return "GEOMETRIC_DOMINANT"
    return "GEOMETRIC_ONLY"


def _normalize(scores: np.ndarray) -> np.ndarray:
    if scores.size == 0:
        return scores
    lo, hi = scores.min(), scores.max()
    if hi - lo < 1e-6:
        return np.full_like(scores, 0.5)
    return (scores - lo) / (hi - lo)


class HybridSelector:
    """Reference-shaped API (hybrid_selector.py:12-66)."""

    def __init__(self, ladder=_LADDER):
        self.ladder = ladder
        self.confidence_manager = ConfidenceManager()

    def select_best_candidate(self, candidates: List[Dict],
                              geometric_scores: Sequence[float],
                              vla_scores: Sequence[float],
                              vla_confidence: float) -> Optional[Dict]:
        if not candidates:
            return None
        weights = confidence_weights(vla_confidence, self.ladder)
        geo = _normalize(np.asarray(geometric_scores, np.float64))
        vla = _normalize(np.asarray(vla_scores, np.float64))
        hybrid = weights["geometric"] * geo + weights["vla"] * vla

        best = int(np.argmax(hybrid))
        out = dict(candidates[best])
        out["hybrid_score"] = float(hybrid[best])
        out["vla_weight"] = weights["vla"]
        out["geometric_weight"] = weights["geometric"]
        return out

    def get_selection_strategy(self, vla_confidence: float) -> str:
        return selection_strategy(vla_confidence)


class HybridGraspSelector:
    """Canonical public API (the name the reference README documents).

    Wires a VLA candidate scorer + confidence manager + weight-ladder
    fusion, degrading gracefully to geometric-only when the scorer is
    absent or fails (the reference's contract,
    leaf_grasp_node_vla.py:59-67,133-137).
    """

    def __init__(self, vla_processor=None, ladder=_LADDER):
        self.processor = vla_processor
        self.selector = HybridSelector(ladder)
        self.confidence_manager = self.selector.confidence_manager

    def select_grasp_point(self, image, candidates: List[Dict],
                           instruction: str =
                           "Select the best leaf for grasping"
                           ) -> Optional[Dict]:
        """candidates: dicts with at least 'x', 'y', 'geometric_score'."""
        if not candidates:
            return None
        geometric = [float(c.get("geometric_score", 0.5))
                     for c in candidates]
        vla_scores = None
        if self.processor is not None:
            try:
                vla_scores = self.processor.evaluate_candidates(
                    image, candidates, instruction)
            except Exception:
                vla_scores = None
        if vla_scores is None:
            vla_scores = [0.5] * len(candidates)

        confidence = self.confidence_manager.calculate_confidence(
            vla_scores, geometric)
        best = self.selector.select_best_candidate(
            candidates, geometric, vla_scores, confidence)
        if best is not None:
            best["vla_confidence"] = confidence
            best["strategy"] = selection_strategy(confidence)
        return best
