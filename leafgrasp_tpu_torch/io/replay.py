"""Offline frame replay + wire-format decoding, the port's own copy of
leafgrasp_tpu/io/replay.py (numpy only).

The reference's test harnesses replay saved frames from disk -- mask
PNGs (color-keyed or id maps) plus depth ``.npy`` files
(leaf_grasp_node.py:63-69, test_leaf_node.py:36-41) -- and its live
nodes receive flat row-major ``int16``/``float32`` buffers over ROS
messages (msg/masks.msg, msg/depth.msg, leaf_grasp_node_v3.py:185-205).
This module provides both: buffer decoding for the ingest API and a
directory replayer for offline evaluation.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Tuple

import numpy as np

__all__ = ["decode_mask_buffer", "decode_depth_buffer",
           "color_keyed_to_ids", "replay_directory"]


def decode_mask_buffer(buf, height: int, width: int) -> np.ndarray:
    """Flat int16 buffer -> (H, W) instance map
    (leaf_grasp_node_v3.py:185-189)."""
    arr = np.asarray(buf, np.int16)
    return arr.reshape(height, width)


def decode_depth_buffer(buf, height: int, width: int) -> np.ndarray:
    """Flat float32 buffer -> (H, W) metric depth
    (leaf_grasp_node_v3.py:196-200)."""
    arr = np.asarray(buf, np.float32)
    return arr.reshape(height, width)


def color_keyed_to_ids(rgb_mask: np.ndarray) -> np.ndarray:
    """Color-keyed mask PNG -> instance id map (the v0/v1 offline nodes
    distinguished leaves by unique colors, leaf_grasp_node.py:70-110).
    Background = black -> id 0; every distinct color gets a stable id
    ordered by first occurrence in row-major order."""
    rgb = np.asarray(rgb_mask)
    if rgb.ndim == 2:
        # already an id/grayscale map
        ids = np.zeros_like(rgb, np.int16)
        for i, val in enumerate(v for v in np.unique(rgb) if v != 0):
            ids[rgb == val] = i + 1
        return ids
    flat = rgb.reshape(-1, rgb.shape[-1])
    key = (flat[:, 0].astype(np.int64) << 16) \
        | (flat[:, 1].astype(np.int64) << 8) | flat[:, 2]
    ids = np.zeros(flat.shape[0], np.int16)
    seen = {}
    uniq, first_idx = np.unique(key, return_index=True)
    order = np.argsort(first_idx)
    next_id = 1
    for u in uniq[order]:
        if u == 0:
            continue
        seen[u] = next_id
        next_id += 1
    for u, i in seen.items():
        ids[key == u] = i
    return ids.reshape(rgb.shape[:2])


def replay_directory(directory: str,
                     mask_pattern: str = r"(?:aggrigated_masks|mask)(\d+)",
                     depth_pattern: str = r"depth(\d+)"
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (mask_ids, depth, frame_no) pairs from a directory holding
    ``*.png`` masks and ``*.npy`` depth files with matching numbers."""
    from PIL import Image
    directory = os.path.expanduser(directory)
    masks, depths = {}, {}
    for name in sorted(os.listdir(directory)):
        base, ext = os.path.splitext(name)
        m = re.search(mask_pattern, base)
        if m and ext.lower() in (".png", ".bmp", ".tif", ".tiff"):
            masks[int(m.group(1))] = os.path.join(directory, name)
            continue
        d = re.search(depth_pattern, base)
        if d and ext.lower() == ".npy":
            depths[int(d.group(1))] = os.path.join(directory, name)
    for frame_no in sorted(set(masks) & set(depths)):
        rgb = np.asarray(Image.open(masks[frame_no]))
        mask_ids = color_keyed_to_ids(rgb)
        depth = np.load(depths[frame_no]).astype(np.float32)
        yield mask_ids, depth, frame_no
