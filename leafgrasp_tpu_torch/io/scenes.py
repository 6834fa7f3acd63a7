"""Synthetic leaf scenes: a numpy-only copy of the JAX package's
``io/scenes.py`` generator (same seeds -> the same frames), so the port's
smoke run and parity tests draw identical golden frames without
importing the JAX package.
"""

from __future__ import annotations

import numpy as np


def make_leaf_scene(
    height: int = 1080,
    width: int = 1440,
    num_leaves: int = 5,
    seed: int = 0,
    depth_near: float = 0.35,
    depth_far: float = 0.75,
    margin: int = 120,
):
    """Generate an instance-id mask map and a depth map with elliptical leaves.

    Returns
    -------
    mask : int16 (H, W) instance ids, 0 = background, ids 1..num_leaves
        (later leaves overwrite earlier ones where they overlap, like a
        painter's algorithm -- matches how YOLO instance maps rasterize).
    depth : float32 (H, W) metric depth; background is a far plane with a
        gentle gradient, each leaf is a smooth bump at its own depth.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)

    mask = np.zeros((height, width), dtype=np.int16)
    # Background: far plane with slight tilt + low-frequency ripple.
    depth = (
        depth_far
        + 0.05 * (yy / height)
        + 0.01 * np.sin(xx / width * 3.1)
    ).astype(np.float32)

    for leaf_id in range(1, num_leaves + 1):
        cx = rng.uniform(margin, width - margin)
        cy = rng.uniform(margin, height - margin)
        a = rng.uniform(90, 170)    # semi-major (px)
        b = rng.uniform(55, 110)    # semi-minor (px)
        theta = rng.uniform(0, np.pi)
        z = rng.uniform(depth_near, depth_far - 0.05)

        ct, st = np.cos(theta), np.sin(theta)
        xr = (xx - cx) * ct + (yy - cy) * st
        yr = -(xx - cx) * st + (yy - cy) * ct
        r2 = (xr / a) ** 2 + (yr / b) ** 2
        inside = r2 <= 1.0

        mask[inside] = leaf_id
        # Leaf surface: gentle paraboloid bulge toward the camera.
        leaf_depth = z + 0.015 * r2
        depth[inside] = leaf_depth[inside].astype(np.float32)

    return mask, depth

