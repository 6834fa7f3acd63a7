"""Statistics over every sample of a window: no best-of, no median of
chunks."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the closest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Items completed over the seconds they took."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds
