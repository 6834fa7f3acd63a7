"""Manual-QA tools: midrib detection + angle quantification, PyTorch
port of leafgrasp_tpu/io/tools.py (host-side numpy around the port's
``mask_orientation``, which runs on the CPU here).

Rebuilds of the reference's visualization-only helpers:
* ``detect_midrib`` (grasp_point_selector.py:829-922): intensity-ridge
  sampling perpendicular to the leaf's major axis (host-side numpy; the
  CLAHE/Canny steps of the reference only served to sharpen the same
  ridge and are replaced with local contrast normalization);
* ``angle_error`` (leaf_angle_quantifier.py:36-130): compare a
  human-annotated midrib line against the estimated major-axis angle --
  the measurement core of the reference's interactive clicker, exposed
  as a library call so it works in batch instead of an OpenCV window.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from leafgrasp_tpu_torch.ops.pca import mask_orientation

__all__ = ["detect_midrib", "angle_error", "quantify_angles"]


def detect_midrib(leaf_mask: np.ndarray, image: np.ndarray,
                  num_samples: int = 20
                  ) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Estimate the midrib line of a leaf from image intensity.

    Returns (start_xy, end_xy) or None when the leaf is degenerate.
    """
    mask = np.ascontiguousarray(leaf_mask, bool)
    if not mask.any():
        return None
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    # local contrast normalization over the leaf
    vals = img[mask]
    lo, hi = np.percentile(vals, [5, 95])
    enhanced = np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)

    o = mask_orientation(torch.from_numpy(mask))
    if not bool(o.valid):
        return None
    cx, cy = float(o.center[0]), float(o.center[1])
    ang = float(o.angle)
    major = float(o.major_axis)
    minor = float(o.minor_axis)
    dx, dy = major / 2 * np.cos(ang), major / 2 * np.sin(ang)
    width = max(int(minor / 6), 2)

    h, w = mask.shape
    perp = np.array([-dy, dx])
    n = np.hypot(dx, dy)
    if n < 1e-6:
        return None
    perp = perp / n * width

    ridge_points: List[Tuple[int, int]] = []
    for t in np.linspace(0, 1, num_samples):
        x = cx - dx + 2 * dx * t
        y = cy - dy + 2 * dy * t
        best_val, best_pt = -1.0, None
        for s in np.linspace(-1, 1, 2 * width + 1):
            sx = int(x + s * perp[0])
            sy = int(y + s * perp[1])
            if 0 <= sx < w and 0 <= sy < h and mask[sy, sx]:
                if enhanced[sy, sx] > best_val:
                    best_val = enhanced[sy, sx]
                    best_pt = (sx, sy)
        if best_pt is not None:
            ridge_points.append(best_pt)
    if len(ridge_points) < 2:
        return None
    return ridge_points[0], ridge_points[-1]


def angle_error(leaf_mask: np.ndarray,
                clicked: Tuple[Tuple[float, float], Tuple[float, float]]
                ) -> dict:
    """Compare a manual 2-point midrib annotation against the estimated
    major-axis angle. Angles folded into [0, 90] degrees difference
    (direction-agnostic), as the reference quantifier reports."""
    (x1, y1), (x2, y2) = clicked
    manual = np.degrees(np.arctan2(y2 - y1, x2 - x1)) % 180.0
    o = mask_orientation(torch.from_numpy(
        np.ascontiguousarray(leaf_mask, bool)))
    est = float(np.degrees(o.angle.numpy())) % 180.0
    diff = abs(manual - est)
    diff = min(diff, 180.0 - diff)
    return {"manual_deg": manual, "estimated_deg": est,
            "error_deg": diff, "valid": bool(o.valid)}


def quantify_angles(mask: np.ndarray, annotations: dict) -> List[dict]:
    """Batch version of the reference's interactive session: annotations
    maps leaf_id -> ((x1, y1), (x2, y2))."""
    out = []
    for leaf_id, clicked in annotations.items():
        r = angle_error(mask == leaf_id, clicked)
        r["leaf_id"] = int(leaf_id)
        out.append(r)
    return out
