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


def make_hard_leaf_scene(
    height: int = 1080,
    width: int = 1440,
    num_leaves: int = 8,
    seed: int = 0,
    depth_near: float = 0.35,
    depth_far: float = 0.75,
    margin: int = 120,
    noise_std: float = 0.004,
    speckle_frac: float = 0.002,
):
    """A deliberately HARD scene: clustered overlapping lobed leaves,
    tilted noisy surfaces, occlusion.

    ``make_leaf_scene``'s clean ellipses are linearly separable for the
    grasp CNN. This generator attacks each easy axis:

    * leaf boundary = angularly modulated ellipse (2-5 lobes) -- tips
      and concavities instead of a smooth rim;
    * centers draw around 1-3 cluster anchors -> heavy overlap; later
      leaves occlude earlier ones (painter's order, like YOLO masks);
    * per-leaf tilt plane + paraboloid + CORRELATED surface noise (a
      box-smoothed white field) so flatness varies across a leaf;
    * sensor-grade depth noise everywhere + salt speckle outliers
      (RAFT-stereo artifacts).

    Same return contract as :func:`make_leaf_scene`.
    """
    rng = np.random.default_rng(seed)
    margin = min(margin, height // 3, width // 3)  # stay valid on tiny frames
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)

    mask = np.zeros((height, width), dtype=np.int16)
    depth = (
        depth_far
        + 0.05 * (yy / height)
        + 0.01 * np.sin(xx / width * 3.1)
    ).astype(np.float32)

    n_clusters = int(rng.integers(1, 4))
    anchors = np.stack([
        rng.uniform(margin, width - margin, n_clusters),
        rng.uniform(margin, height - margin, n_clusters)], axis=1)
    spread = min(height, width) * 0.22

    for leaf_id in range(1, num_leaves + 1):
        ax, ay = anchors[int(rng.integers(n_clusters))]
        cx = float(np.clip(ax + rng.normal(0, spread),
                           margin * 0.5, width - margin * 0.5))
        cy = float(np.clip(ay + rng.normal(0, spread),
                           margin * 0.5, height - margin * 0.5))
        a = rng.uniform(90, 180)
        b = rng.uniform(50, 115)
        theta = rng.uniform(0, np.pi)
        z = rng.uniform(depth_near, depth_far - 0.08)

        ct, st = np.cos(theta), np.sin(theta)
        xr = (xx - cx) * ct + (yy - cy) * st
        yr = -(xx - cx) * st + (yy - cy) * ct
        # lobed boundary: radius modulated over polar angle
        phi = np.arctan2(yr / b, xr / a)
        lobes = int(rng.integers(2, 6))
        amp = rng.uniform(0.08, 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        r_mod = 1.0 + amp * np.sin(lobes * phi + phase)
        r2 = (xr / a) ** 2 + (yr / b) ** 2
        inside = r2 <= r_mod ** 2

        mask[inside] = leaf_id
        # tilted plane + bulge + correlated ripple
        gx, gy = rng.uniform(-0.03, 0.03, 2)
        surf = (z + gx * (xr / a) + gy * (yr / b) + 0.015 * r2
                + 0.006 * np.sin(xr / 17.0 + phase)
                * np.cos(yr / 23.0)).astype(np.float32)
        depth[inside] = surf[inside]

    # correlated sensor noise: box-smoothed white noise (cheap, no scipy)
    white = rng.normal(0.0, 1.0, (height // 4 + 1, width // 4 + 1))
    corr = np.kron(white, np.ones((4, 4)))[:height, :width]
    depth += (noise_std * corr).astype(np.float32)
    depth += rng.normal(0.0, noise_std * 0.5,
                        depth.shape).astype(np.float32)
    # speckle outliers
    n_spk = int(speckle_frac * height * width)
    if n_spk:
        sy = rng.integers(0, height, n_spk)
        sx = rng.integers(0, width, n_spk)
        depth[sy, sx] += rng.uniform(-0.08, 0.08, n_spk).astype(np.float32)
    np.clip(depth, 0.05, None, out=depth)
    return mask, depth


def default_projection(fx: float = 1750.68, cx: float = 707.87,
                       cy: float = 494.07, baseline: float = 0.124):
    """3x4 projection matrix matching the reference camera
    (reference leaf_grasp_node_2.py:23-27)."""
    p = np.zeros((3, 4), dtype=np.float64)
    p[0, 0] = fx
    p[1, 1] = fx
    p[0, 2] = cx
    p[1, 2] = cy
    p[2, 2] = 1.0
    p[0, 3] = -fx * baseline
    return p
