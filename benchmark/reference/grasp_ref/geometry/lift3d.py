# Frozen copy of leafgrasp_tpu_torch/geometry/lift3d.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""2D -> 3D lifting and the pre-grasp ray march, PyTorch port of
leafgrasp_tpu/geometry/lift3d.py (grasp_point_selector.py:152-180,
754-826)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.grasp_ref.config import PreGraspConfig
from benchmark.reference.grasp_ref.ops.morphology import elliptical_kernel

__all__ = ["lift_to_3d", "lift_to_3d_with_cloud", "project_to_2d",
           "pre_grasp_point", "PreGrasp"]


def lift_to_3d(u, v, depth_value, camera_cx, camera_cy, f_norm):
    """Pinhole back-projection (grasp_point_selector.py:152-162)."""
    d = depth_value.to(torch.float32)
    return torch.stack([d * (u - camera_cx) / f_norm,
                        d * (v - camera_cy) / f_norm, d])


def lift_to_3d_with_cloud(u, v, depth_value, points, camera_cx, camera_cy,
                          f_norm, threshold_m: float = 0.01):
    """Depth back-projection cross-checked against an organized (H, W, 3)
    cloud: the cloud point wins when the two disagree by more than
    ``threshold_m`` (NaN cloud entries never win)."""
    depth_pt = lift_to_3d(u, v, depth_value, camera_cx, camera_cy, f_norm)
    pts = points.to(torch.float32)
    h, w = pts.shape[0], pts.shape[1]
    ui, vi = u.to(torch.int64), v.to(torch.int64)
    in_cloud = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    cloud_pt = pts[torch.clamp(vi, 0, h - 1), torch.clamp(ui, 0, w - 1)]
    diff = torch.linalg.vector_norm(depth_pt - cloud_pt)
    use_cloud = in_cloud & (diff > threshold_m)
    return torch.where(use_cloud, cloud_pt, depth_pt)


def project_to_2d(points, camera_cx, camera_cy, f_norm):
    """(..., 3) points -> integer pixels, truncating toward zero
    (grasp_point_selector.py:821-826)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    u = torch.trunc(x * f_norm / z + camera_cx).to(torch.int64)
    v = torch.trunc(y * f_norm / z + camera_cy).to(torch.int64)
    return u, v


class PreGrasp(NamedTuple):
    point: torch.Tensor        # (3,) float32
    from_search: torch.Tensor  # bool


def pre_grasp_point(grasp_point_3d: torch.Tensor, leaf_mask: torch.Tensor,
                    camera_cx, camera_cy, f_norm,
                    cfg: PreGraspConfig = PreGraspConfig(), row0: int = 0,
                    frame_height: int | None = None,
                    any_reduce=None) -> PreGrasp:
    """March 5..10 cm back along the camera ray at constant Z; take the
    first test point inside the image, clear of the 15 px-dilated leaf
    mask and >= min_distance from the grasp, else the max-distance point.
    Only the test pixels' SE windows are read (no full-frame dilation).

    Row-sharded callers pass their block of the mask with its ``row0``,
    the ``frame_height`` and ``any_reduce`` (a cross-shard SUM of the
    int32 per-step cover counts): each window cell is read by the one
    shard that holds its row, so the summed cover is the frame's."""
    g = grasp_point_3d.to(torch.float32)
    m = leaf_mask.to(torch.bool)
    h, w = m.shape
    fh = h if frame_height is None else frame_height
    dev = m.device
    direction = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-30)
    k = 2 * cfg.clearance_px + 1
    n_steps = int(round((cfg.max_distance_m - cfg.min_distance_m)
                        / cfg.step_m))
    dists = cfg.min_distance_m + cfg.step_m * torch.arange(
        n_steps, dtype=torch.float32, device=dev)
    pts = torch.stack([g[0] - direction[0] * dists,
                       g[1] - direction[1] * dists,
                       g[2].expand(n_steps)], dim=1)            # (S, 3)
    us, vs = project_to_2d(pts, camera_cx, camera_cy, f_norm)
    in_bounds = (us >= 0) & (us < w) & (vs >= 0) & (vs < fh)
    uc = torch.clamp(us, 0, w - 1)
    vc = torch.clamp(vs, 0, fh - 1)

    se = torch.as_tensor(elliptical_kernel(k, k), device=dev).to(torch.bool)
    offs = torch.arange(k, device=dev) - k // 2
    grows = vc[:, None] + offs[None, :]                         # (S, k)
    gcols = uc[:, None] + offs[None, :]
    rows_ok = (grows >= 0) & (grows < fh) & (grows >= row0) \
        & (grows < row0 + h)
    cols_ok = (gcols >= 0) & (gcols < w)
    window = m[torch.clamp(grows - row0, 0, h - 1)[:, :, None],
               torch.clamp(gcols, 0, w - 1)[:, None, :]]        # (S, k, k)
    valid = rows_ok[:, :, None] & cols_ok[:, None, :]
    cover = (window & valid & se[None]).flatten(1).any(dim=1)
    if any_reduce is not None:
        cover = any_reduce(cover.to(torch.int32)) > 0
    far_enough = torch.linalg.vector_norm(pts - g[None, :], dim=1) \
        >= cfg.min_distance_m
    ok = in_bounds & ~cover & far_enough

    first = torch.argmax(ok.to(torch.int32))
    found = ok.any()
    fallback = torch.stack([g[0] - direction[0] * cfg.max_distance_m,
                            g[1] - direction[1] * cfg.max_distance_m, g[2]])
    return PreGrasp(point=torch.where(found, pts[first], fallback),
                    from_search=found)
