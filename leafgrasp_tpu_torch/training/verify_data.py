"""Dataset sanity checker (rebuild of reference scripts/verify_data.py),
a copy of leafgrasp_tpu/training/verify_data.py (numpy only).

Programmatic (returns a report dict + `ok` flag) instead of
assert-by-print, so it runs in CI and as a library call.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["verify_dataset"]

SCORE_NAMES = ("sdf", "approach", "flatness", "isolation", "distance",
               "accessibility", "stem")


def verify_dataset(data: Dict[str, np.ndarray],
                   patch_size: int = 32) -> Dict:
    """Checks: shapes, value ranges, NaN/Inf, mask binarity, label
    distribution, grasp-point bounds (verify_data.py:12-47)."""
    problems = []
    n = len(data["labels"])

    def check(cond, msg):
        if not cond:
            problems.append(msg)

    check(data["depth_patches"].shape == (n, patch_size, patch_size),
          "depth_patches shape")
    check(data["mask_patches"].shape == (n, patch_size, patch_size),
          "mask_patches shape")
    check(data["score_patches"].shape == (n, 7, patch_size, patch_size),
          "score_patches shape")

    for key in ("depth_patches", "mask_patches", "score_patches"):
        arr = np.asarray(data[key])
        check(np.isfinite(arr).all(), f"{key} contains NaN/Inf")

    mask_vals = np.unique(data["mask_patches"])
    check(set(np.round(mask_vals, 6)) <= {0.0, 1.0}, "mask not binary")

    labels = np.asarray(data["labels"])
    check(set(np.unique(labels)) <= {0, 1}, "labels not 0/1")

    # Augmented samples inherit the reference's quirk of rotating the
    # full-image grasp coordinate about the PATCH center
    # (data_collector.py:278,401-419), which can leave the patch bounds;
    # only original samples are bound-checked.
    pts = np.asarray(data["grasp_points"])
    orig = ~np.asarray(data["is_augmented"])
    check((pts[orig] >= 0).all(), "negative grasp point coords")

    report = {
        "ok": not problems,
        "problems": problems,
        "num_samples": int(n),
        "positive": int((labels == 1).sum()),
        "negative": int((labels == 0).sum()),
        "augmented": int(np.asarray(data["is_augmented"]).sum()),
        "depth_range": [float(data["depth_patches"].min()),
                        float(data["depth_patches"].max())],
        "score_ranges": {
            name: [float(data["score_patches"][:, i].min()),
                   float(data["score_patches"][:, i].max())]
            for i, name in enumerate(SCORE_NAMES)},
        "center_depth_mean": float(
            data["depth_patches"][:, patch_size // 2,
                                  patch_size // 2].mean()),
    }
    return report
