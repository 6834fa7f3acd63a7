"""Host-side result visualization, PyTorch port of
leafgrasp_tpu/pipeline/visualizer.py (rebuild of
scripts/utils/visualizer.py).

Renders, per frame: color-coded leaves (tall = blue, regular = green,
selected = red, visualizer.py:172-201), the selected leaf's contour band
with an eroded safety margin (visualizer.py:203-253), the major-axis
orientation arrow, grasp / pre-grasp markers with 3D coordinate text
(visualizer.py:93-124), and an optional side-by-side composite with the
rectified RGB frame. Drawing is numpy on the host, outside the frame
path; the morphology and the rectangle run through the port's ops on
CPU tensors. ``render`` needs numpy only except for the text annotation
and the midrib line, which use PIL when it is installed and are left
out when it is not; ``save`` needs PIL.
"""

from __future__ import annotations

import colorsys
import os
from typing import Dict, Optional

import numpy as np
import torch

from leafgrasp_tpu_torch.ops.morphology import (elliptical_kernel, erode,
                                                morphological_boundary)
from leafgrasp_tpu_torch.ops.pca import min_area_rect

__all__ = ["LeafVisualizer", "generate_color"]

_COLOR_CACHE: Dict[int, tuple] = {}


def _boundary(mask: np.ndarray) -> np.ndarray:
    """The contour band of a numpy mask."""
    return morphological_boundary(
        torch.from_numpy(np.ascontiguousarray(mask, bool))).numpy()


def _pil():
    """(Image, ImageDraw), or None when PIL is not installed."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return None
    return Image, ImageDraw


def generate_color(leaf_id: int) -> tuple:
    """Golden-ratio HSV palette (image_processor.py:40-47)."""
    if leaf_id not in _COLOR_CACHE:
        golden_ratio = 0.618033988749895
        hue = (leaf_id * golden_ratio) % 1.0
        rgb = colorsys.hsv_to_rgb(hue, 0.8, 0.95)
        _COLOR_CACHE[leaf_id] = tuple(int(255 * x) for x in rgb)
    return _COLOR_CACHE[leaf_id]


class LeafVisualizer:
    TALL = (80, 120, 255)        # blue-ish
    REGULAR = (90, 200, 90)      # green
    SELECTED = (230, 60, 60)     # red
    MARGIN = (250, 220, 60)      # yellow safety margin

    def __init__(self, out_dir: Optional[str] = None,
                 safety_margin_kernel: int = 21):
        self.out_dir = os.path.expanduser(out_dir) if out_dir else None
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        self.margin_kernel = safety_margin_kernel
        self._count = 0

    def render(self, mask: np.ndarray, selected_leaf: int,
               grasp_uv=None, grasp_xyz=None, pre_grasp_xyz=None,
               tall_leaves=(), rgb: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """Returns an (H, W, 3) uint8 frame (or (H, 2W, 3) composite)."""
        h, w = mask.shape
        canvas = np.zeros((h, w, 3), np.uint8)
        tall = set(int(t) for t in tall_leaves)

        for leaf_id in np.unique(mask):
            if leaf_id == 0:
                continue
            m = mask == leaf_id
            if leaf_id == selected_leaf:
                color = self.SELECTED
            elif int(leaf_id) in tall:
                color = self.TALL
            else:
                color = self.REGULAR
            canvas[m] = color

        sel = mask == selected_leaf
        if sel.any():
            canvas[_boundary(sel)] = (255, 255, 255)
            eroded = erode(torch.from_numpy(np.ascontiguousarray(sel)),
                           elliptical_kernel(self.margin_kernel)).numpy()
            margin_band = _boundary(eroded) if eroded.any() \
                else np.zeros_like(sel)
            canvas[margin_band] = self.MARGIN
            self._draw_orientation(canvas, sel)

        if grasp_uv is not None:
            self._draw_marker(canvas, int(grasp_uv[0]), int(grasp_uv[1]),
                              (255, 255, 255))
        if pre_grasp_xyz is not None and grasp_xyz is not None:
            canvas = self._annotate(canvas, grasp_uv, grasp_xyz,
                                    pre_grasp_xyz)

        if rgb is not None:
            rgb8 = np.asarray(rgb)
            if rgb8.dtype != np.uint8:
                rgb8 = (np.clip(rgb8, 0, 1) * 255).astype(np.uint8)
            if rgb8.ndim == 2:
                rgb8 = np.stack([rgb8] * 3, -1)
            # draw the detected midrib on the RGB half of the composite
            # (reference visualizer.py:129-157: red 3px line + label)
            if sel.any():
                rgb8 = rgb8.copy()
                self._draw_midrib(rgb8, sel)
            canvas = np.concatenate([rgb8, canvas], axis=1)
        return canvas

    def save(self, frame: np.ndarray, name: Optional[str] = None) -> str:
        from PIL import Image
        if self.out_dir is None:
            raise ValueError("visualizer created without out_dir")
        name = name or f"optimal_leaf_{self._count}.png"
        self._count += 1
        path = os.path.join(self.out_dir, name)
        Image.fromarray(frame).save(path)
        return path

    def visualize_result(self, mask, selected_leaf, grasp_uv=None,
                         grasp_xyz=None, pre_grasp_xyz=None,
                         tall_leaves=(), rgb=None,
                         name: Optional[str] = None) -> str:
        frame = self.render(np.asarray(mask), int(selected_leaf),
                            grasp_uv, grasp_xyz, pre_grasp_xyz,
                            tall_leaves, rgb)
        return self.save(frame, name)

    # ------------------------------------------------------- internals --

    @staticmethod
    def _draw_marker(canvas, x, y, color, radius: int = 6):
        h, w = canvas.shape[:2]
        yy, xx = np.ogrid[max(0, y - radius):min(h, y + radius + 1),
                          max(0, x - radius):min(w, x + radius + 1)]
        ring = np.abs(np.hypot(yy - y, xx - x) - radius) < 1.5
        cross = (np.abs(yy - y) < 1) | (np.abs(xx - x) < 1)
        region = canvas[max(0, y - radius):min(h, y + radius + 1),
                        max(0, x - radius):min(w, x + radius + 1)]
        region[ring | cross] = color

    @staticmethod
    def _draw_midrib(rgb8, sel, thickness: int = 3):
        from leafgrasp_tpu_torch.io.tools import detect_midrib
        pil = _pil()
        pts = detect_midrib(sel, rgb8) if pil else None
        if pts is None:
            return
        Image, ImageDraw = pil
        img = Image.fromarray(rgb8)
        draw = ImageDraw.Draw(img)
        (x1, y1), (x2, y2) = pts
        draw.line([(x1, y1), (x2, y2)], fill=(255, 0, 0), width=thickness)
        draw.text((x1, max(0, y1 - 12)), "Midrib", fill=(255, 0, 0))
        rgb8[:] = np.asarray(img)

    def _draw_orientation(self, canvas, sel):
        # the reference draws estimate_leaf_orientation's axis
        # (= minAreaRect; visualizer.py:76-88) -- use the exact
        # rectangle, not moment-PCA
        o = min_area_rect(torch.from_numpy(np.ascontiguousarray(sel)))
        if not bool(o.valid):
            return
        cx, cy = float(o.center[0]), float(o.center[1])
        ang = float(o.angle)
        L = float(o.major_axis) / 2.0
        ts = np.linspace(-L, L, int(2 * L) + 1)
        xs = (cx + ts * np.cos(ang)).astype(int)
        ys = (cy + ts * np.sin(ang)).astype(int)
        h, w = canvas.shape[:2]
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        canvas[ys[ok], xs[ok]] = (255, 255, 255)

    @staticmethod
    def _annotate(canvas, grasp_uv, grasp_xyz, pre_grasp_xyz):
        pil = _pil()
        if pil is None:
            return canvas
        Image, ImageDraw = pil
        img = Image.fromarray(canvas)
        draw = ImageDraw.Draw(img)
        g = np.asarray(grasp_xyz, float)
        p = np.asarray(pre_grasp_xyz, float)
        lines = [
            f"grasp uv=({int(grasp_uv[0])},{int(grasp_uv[1])})",
            f"grasp xyz=({g[0]:.3f},{g[1]:.3f},{g[2]:.3f})m",
            f"pre-grasp=({p[0]:.3f},{p[1]:.3f},{p[2]:.3f})m",
        ]
        for i, line in enumerate(lines):
            draw.text((8, 8 + 14 * i), line, fill=(255, 255, 255))
        return np.asarray(img)
