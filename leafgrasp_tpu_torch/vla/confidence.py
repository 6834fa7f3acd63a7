"""VLA confidence estimation (rebuild of vla_system/confidence_manager.py).

Pure functions + a thin rolling-history wrapper: confidence =
0.4 * consistency (rescaled Pearson corr of min-max-normalized VLA vs
geometric scores) + 0.3 * (1 - normalized variance) + 0.3 * magnitude
(max * (1 + range/2)), clipped to [0, 1]
(confidence_manager.py:11-64).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["score_consistency", "score_variance", "score_magnitude",
           "calculate_confidence", "ConfidenceManager"]


def _minmax(a: np.ndarray) -> np.ndarray:
    return (a - a.min()) / (a.max() - a.min() + 1e-6)


def score_consistency(vla_scores: Sequence[float],
                      geometric_scores: Sequence[float]) -> float:
    v = np.asarray(vla_scores, np.float64)
    g = np.asarray(geometric_scores, np.float64)
    if v.size < 2:
        return 0.5
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.corrcoef(_minmax(v), _minmax(g))[0, 1]
    if np.isnan(corr):
        return 0.5
    return float((corr + 1.0) / 2.0)


def score_variance(scores: Sequence[float]) -> float:
    s = np.asarray(scores, np.float64)
    if s.size < 2:
        return 1.0
    normalized = np.var(s) / (np.mean(s) + 1e-6)
    return float(np.clip(normalized, 0.0, 1.0))


def score_magnitude(scores: Sequence[float]) -> float:
    s = np.asarray(scores, np.float64)
    if s.size == 0:
        return 0.0
    mag = s.max() * (1.0 + (s.max() - s.min()) / 2.0)
    return float(np.clip(mag, 0.0, 1.0))


def calculate_confidence(vla_scores: Sequence[float],
                         geometric_scores: Sequence[float],
                         consistency_weight: float = 0.4,
                         variance_weight: float = 0.3,
                         magnitude_weight: float = 0.3) -> float:
    if len(vla_scores) == 0 or len(geometric_scores) == 0:
        return 0.0
    c = (consistency_weight * score_consistency(vla_scores,
                                                geometric_scores)
         + variance_weight * (1.0 - score_variance(vla_scores))
         + magnitude_weight * score_magnitude(vla_scores))
    return float(np.clip(c, 0.0, 1.0))


class ConfidenceManager:
    """Rolling-history wrapper (confidence_manager.py:66-82)."""

    def __init__(self, max_history: int = 10):
        self.max_history = max_history
        self.confidence_history: List[float] = []

    def calculate_confidence(self, vla_scores, geometric_scores) -> float:
        c = calculate_confidence(vla_scores, geometric_scores)
        self.confidence_history.append(c)
        if len(self.confidence_history) > self.max_history:
            self.confidence_history.pop(0)
        return c

    def get_running_confidence(self) -> float:
        if not self.confidence_history:
            return 0.0
        return float(np.mean(self.confidence_history[-5:]))

    def is_stable(self, threshold: float = 0.1) -> bool:
        if len(self.confidence_history) < 3:
            return False
        return float(np.std(self.confidence_history[-3:])) < threshold
