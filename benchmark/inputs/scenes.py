"""Synthetic leaf scenes drawn on the card.

A port of the port's numpy generators (``leafgrasp_tpu_torch/io/
scenes.py`` ``make_leaf_scene`` and ``make_hard_leaf_scene`` at commit
8d152a04df5e, themselves copies of the JAX package's): the same shapes,
parameter ranges and painter's order, with each leaf's parameters drawn
on the host from a numpy generator and every per-pixel field computed
on the device (the noise fields from a ``torch.Generator`` there), so a
pool of 1080 x 1440 scenes takes milliseconds and not the numpy
version's seconds a scene. The same seed gives the same scenes; they
are not the numpy version's frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _grid(h, w, dev):
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] \
        .expand(h, w)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] \
        .expand(h, w)
    return yy, xx


def _background(yy, xx, h, w, depth_far):
    return (depth_far + 0.05 * (yy / h)
            + 0.01 * torch.sin(xx / w * 3.1)).to(torch.float32)


def leaf_scene(rng: np.random.Generator, h: int, w: int, num_leaves: int,
               margin: int, dev, depth_near: float = 0.35,
               depth_far: float = 0.75):
    """(mask int16, depth float32) on ``dev``: elliptical leaves. The
    margin is held to a third of the frame (no change at 1080 x 1440)."""
    margin = min(margin, h // 3, w // 3)
    yy, xx = _grid(h, w, dev)
    mask = torch.zeros((h, w), dtype=torch.int16, device=dev)
    depth = _background(yy, xx, h, w, depth_far)
    for leaf_id in range(1, num_leaves + 1):
        cx = rng.uniform(margin, w - margin)
        cy = rng.uniform(margin, h - margin)
        a = rng.uniform(90, 170)
        b = rng.uniform(55, 110)
        theta = rng.uniform(0, np.pi)
        z = rng.uniform(depth_near, depth_far - 0.05)
        ct, st = math.cos(theta), math.sin(theta)
        xr = (xx - cx) * ct + (yy - cy) * st
        yr = -(xx - cx) * st + (yy - cy) * ct
        r2 = (xr / a) ** 2 + (yr / b) ** 2
        inside = r2 <= 1.0
        mask[inside] = leaf_id
        depth = torch.where(inside, z + 0.015 * r2, depth)
    return mask, depth


def hard_leaf_scene(rng: np.random.Generator, gen: torch.Generator, h: int,
                    w: int, num_leaves: int, margin: int, dev,
                    depth_near: float = 0.35, depth_far: float = 0.75,
                    noise_std: float = 0.004, speckle_frac: float = 0.002):
    """(mask int16, depth float32) on ``dev``: clustered lobed leaves,
    tilted noisy surfaces, correlated sensor noise and speckle."""
    margin = min(margin, h // 3, w // 3)
    yy, xx = _grid(h, w, dev)
    mask = torch.zeros((h, w), dtype=torch.int16, device=dev)
    depth = _background(yy, xx, h, w, depth_far)
    n_clusters = int(rng.integers(1, 4))
    anchors = np.stack([rng.uniform(margin, w - margin, n_clusters),
                        rng.uniform(margin, h - margin, n_clusters)], axis=1)
    spread = min(h, w) * 0.22
    for leaf_id in range(1, num_leaves + 1):
        ax, ay = anchors[int(rng.integers(n_clusters))]
        cx = float(np.clip(ax + rng.normal(0, spread), margin * 0.5,
                           w - margin * 0.5))
        cy = float(np.clip(ay + rng.normal(0, spread), margin * 0.5,
                           h - margin * 0.5))
        a = rng.uniform(90, 180)
        b = rng.uniform(50, 115)
        theta = rng.uniform(0, np.pi)
        z = rng.uniform(depth_near, depth_far - 0.08)
        ct, st = math.cos(theta), math.sin(theta)
        xr = (xx - cx) * ct + (yy - cy) * st
        yr = -(xx - cx) * st + (yy - cy) * ct
        phi = torch.atan2(yr / b, xr / a)
        lobes = int(rng.integers(2, 6))
        amp = rng.uniform(0.08, 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        r_mod = 1.0 + amp * torch.sin(lobes * phi + phase)
        r2 = (xr / a) ** 2 + (yr / b) ** 2
        inside = r2 <= r_mod ** 2
        mask[inside] = leaf_id
        gx, gy = rng.uniform(-0.03, 0.03, 2)
        surf = (z + gx * (xr / a) + gy * (yr / b) + 0.015 * r2
                + 0.006 * torch.sin(xr / 17.0 + phase)
                * torch.cos(yr / 23.0))
        depth = torch.where(inside, surf, depth)
    white = torch.randn((h // 4 + 1, w // 4 + 1), generator=gen, device=dev)
    corr = white.repeat_interleave(4, 0).repeat_interleave(4, 1)[:h, :w]
    depth = depth + noise_std * corr
    depth = depth + noise_std * 0.5 * torch.randn((h, w), generator=gen,
                                                  device=dev)
    n_spk = int(speckle_frac * h * w)
    if n_spk:
        sy = torch.randint(0, h, (n_spk,), generator=gen, device=dev)
        sx = torch.randint(0, w, (n_spk,), generator=gen, device=dev)
        kick = (torch.rand((n_spk,), generator=gen, device=dev) * 0.16
                - 0.08)
        depth = depth.index_put((sy, sx), kick, accumulate=True)
    return mask, torch.clamp(depth, min=0.05).to(torch.float32)


def scene_pool(seed: int, n: int, h: int, w: int, leaves, margins,
               hard_share: float, dev):
    """``n`` scenes from ``seed``. The scenes' leaf counts run evenly
    over ``leaves`` (inclusive), their margins evenly over ``margins``,
    and ``hard_share`` of them, spread evenly, are hard: the
    same set of sizes for every seed, so a seed changes the leaves'
    shapes and places and the order, and not the amount of work.
    Returns a list of (mask, depth) on ``dev``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_hard = int(round(n * hard_share))
    hard_at = set(np.round(np.linspace(0, n - 1, n_hard)).astype(int)
                  .tolist()) if n_hard else set()
    span_l = leaves[1] - leaves[0] + 1
    out = []
    for i in range(n):
        nl = leaves[0] + (i * span_l) // n
        mg = margins[0] + ((i * 7) % n) * (margins[1] - margins[0]) \
            // max(n - 1, 1)
        if i in hard_at:
            out.append(hard_leaf_scene(rng, gen, h, w, nl, mg, dev))
        else:
            out.append(leaf_scene(rng, h, w, nl, mg, dev))
    return [out[j] for j in rng.permutation(n)]


def render_rgb(mask: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A (H, W, 3) uint8 camera image for a mask: each leaf a shade of
    green, the background brown, with sensor noise."""
    dev = mask.device
    n = int(mask.max().item()) + 1 if mask.numel() else 1
    palette = torch.rand((max(n, 1), 3), generator=gen, device=dev)
    palette = palette * torch.tensor([60.0, 90.0, 50.0], device=dev) \
        + torch.tensor([30.0, 110.0, 30.0], device=dev)
    palette[0] = torch.tensor([110.0, 80.0, 50.0], device=dev)
    img = palette[mask.long()]
    img = img + 12.0 * torch.randn(img.shape, generator=gen, device=dev)
    return img.clamp(0, 255).to(torch.uint8)
