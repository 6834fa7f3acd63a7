"""Frozen copy of the port's LLaVA-NeXT (v1.6) anyres geometry, resize,
tiling and packing (``leafgrasp_tpu_torch/vla/llava_next.py`` at commit
8d152a04df5e: everything from ``CLIP_IMAGE_MEAN`` to
``preprocess_anyres``), so the plain reference works the tiles and the
packed feature order out again from the camera image. Pillow's bicubic
resize for 8-bit images, HF's best resolution, unpadding and newline
rows, as there.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

# the llava-v1.6-mistral-7b anyres grid (frozen copy of
# tools/_torch_bench.py V16_PINPOINTS)
V16_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                 (336, 1008))

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def select_best_resolution(image_hw: Tuple[int, int],
                           pinpoints: Sequence[Sequence[int]]
                           ) -> Tuple[int, int]:
    """HF select_best_resolution: maximize effective resolution, then
    minimize wasted area. image_hw and pinpoints are (height, width)."""
    oh, ow = image_hw
    best, best_eff, best_waste = None, -1, float("inf")
    for ph, pw in pinpoints:
        scale = min(pw / ow, ph / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = pw * ph - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (ph, pw), eff, waste
    return best


def anyres_grid_shape(image_hw, pinpoints, tile_size: int):
    """(grid_w_tiles, grid_h_tiles): HF returns (width // tile,
    height // tile)."""
    ph, pw = select_best_resolution(image_hw, pinpoints)
    return pw // tile_size, ph // tile_size


def unpad_feature_grid(grid: np.ndarray, image_hw) -> np.ndarray:
    """HF unpad_image on a (H, W, D) feature grid: crop the padding that
    letterboxing added for the original aspect ratio."""
    oh, ow = image_hw
    ch, cw = grid.shape[:2]
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        return grid[pad:ch - pad, :]
    new_w = int(round(ow * (ch / oh), 7))
    pad = (cw - new_w) // 2
    return grid[:, pad:cw - pad]


def _pack_plan(image_hw, pinpoints, cfg):
    """Packing geometry shared by the host and device packers:
    (patches_per_side, grid_w, grid_h, unpad row/col crop), all Python
    ints."""
    pp = cfg.image_size // cfg.patch_size
    gw, gh = anyres_grid_shape(image_hw, pinpoints, cfg.image_size)
    oh, ow = image_hw
    ch, cw = gh * pp, gw * pp
    if ow / oh > cw / ch:                 # mirror unpad_feature_grid
        pad = (ch - int(round(oh * (cw / ow), 7))) // 2
        crop = (pad, ch - pad, 0, cw)
    else:
        pad = (cw - int(round(ow * (ch / oh), 7))) // 2
        crop = (0, ch, pad, cw - pad)
    return pp, gw, gh, crop


def pack_anyres_features(tile_features: np.ndarray, image_hw,
                         pinpoints, cfg, image_newline: np.ndarray
                         ) -> np.ndarray:
    """(num_tiles, patches, D) tile features (tile 0 = base image) ->
    (N, D) packed sequence: base features first, then the unpadded
    spatial grid with a newline embedding appended to every row."""
    tile_features = np.asarray(tile_features)
    base = tile_features[0]
    spatial = tile_features[1:]
    pp, gw, gh, (r0, r1, c0, c1) = _pack_plan(image_hw, pinpoints, cfg)
    d = tile_features.shape[-1]
    grid = spatial.reshape(gh, gw, pp, pp, d)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(gh * pp, gw * pp, d)
    grid = grid[r0:r1, c0:c1]
    newline = np.broadcast_to(np.asarray(image_newline),
                              (grid.shape[0], 1, d))
    grid = np.concatenate([grid, newline], axis=1)
    return np.concatenate([base, grid.reshape(-1, d)], axis=0)


def pack_anyres_features_torch(tile_features: torch.Tensor, image_hw,
                               pinpoints, cfg, image_newline: torch.Tensor
                               ) -> torch.Tensor:
    """Device twin of pack_anyres_features (same plan, tensor ops): the
    tile features never leave the device."""
    pp, gw, gh, (r0, r1, c0, c1) = _pack_plan(image_hw, pinpoints, cfg)
    base = tile_features[0]
    spatial = tile_features[1:]
    d = tile_features.shape[-1]
    grid = spatial.reshape(gh, gw, pp, pp, d)
    grid = grid.permute(0, 2, 1, 3, 4).reshape(gh * pp, gw * pp, d)
    grid = grid[r0:r1, c0:c1]
    newline = image_newline.to(device=grid.device, dtype=grid.dtype) \
        .expand(grid.shape[0], 1, d)
    grid = torch.cat([grid, newline], dim=1)
    return torch.cat([base, grid.reshape(-1, d)], dim=0)


def _patch_output_size(oh: int, ow: int, th: int, tw: int):
    """HF get_patch_output_size: the dominant axis fills the target, the
    other is rounded up."""
    scale_w = tw / ow
    scale_h = th / oh
    if scale_w < scale_h:
        return min(math.ceil(oh * scale_w), th), tw
    return th, min(math.ceil(ow * scale_h), tw)


# --------------------------------------------------------- bicubic resize --

_PRECISION_BITS = 32 - 8 - 2      # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resize_coeffs(in_size: int, out_size: int):
    """Per output sample: the first input sample and the fixed-point
    weights of its window (Pillow's precompute_coeffs and
    normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    taps = np.arange(ksize, dtype=np.int64)[None, :]
    w = _bicubic((taps + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(taps < (xmax - xmin)[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = w * float(1 << _PRECISION_BITS)
    # round half away from zero, then truncate, as the C cast does
    kk = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)) \
        .astype(np.int32)
    return xmin, kk


def _resample_axis1(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """One pass along axis 1 of an (A, n, C) uint8 image, in exact int32
    arithmetic on the image's device."""
    in_size = img.shape[1]
    xmin, kk = _resize_coeffs(in_size, out_size)
    xmin = torch.as_tensor(xmin, device=img.device)
    kk = torch.as_tensor(kk, device=img.device)
    acc = torch.full((img.shape[0], out_size, img.shape[2]),
                     1 << (_PRECISION_BITS - 1), dtype=torch.int32,
                     device=img.device)
    src = img.to(torch.int32)
    for tap in range(kk.shape[1]):
        idx = torch.clamp(xmin + tap, max=in_size - 1)
        acc += src[:, idx, :] * kk[:, tap][None, :, None]
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def resize_bicubic_u8(img, out_h: int, out_w: int):
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8, as Pillow's
    ``Image.resize((out_w, out_h), BICUBIC)`` computes it: columns
    first, then rows, a pass skipped where the size does not change.
    A tensor is resized on its device and comes back as a tensor; a
    numpy array comes back as a numpy array."""
    as_numpy = not isinstance(img, torch.Tensor)
    x = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    if x.shape[1] != out_w:
        x = _resample_axis1(x, out_w)
    if x.shape[0] != out_h:
        x = _resample_axis1(x.permute(1, 0, 2), out_h).permute(1, 0, 2)
    x = x.contiguous()
    return x.numpy() if as_numpy else x


def clip_normalize(tiles_u8: torch.Tensor) -> torch.Tensor:
    """CLIP normalization of uint8 tiles on their device: u8 -> / 255 ->
    - mean -> / std, all f32 (the same elementwise arithmetic as the
    host path of ``preprocess_anyres``), so tiles travel as bytes."""
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=tiles_u8.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=tiles_u8.device)
    return (tiles_u8.to(torch.float32) / 255.0 - mean) / std


def preprocess_anyres(image: np.ndarray, pinpoints, cfg,
                      normalize: bool = True, device=None):
    """RGB image -> (num_tiles, tile, tile, 3) CLIP-normalized tiles
    (tile 0 = base resize) + the original (h, w): bicubic resizes, HF
    resize rounding, centred zero padding before normalization.

    normalize=False returns the raw uint8 tiles instead. With ``device``
    the image goes to that device as bytes, is resized, tiled and
    normalized there, and the tiles come back as a tensor on it (the
    serving scorer's way); without it everything is numpy on the host.
    The two give the same bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    oh, ow = img.shape[:2]
    t = cfg.image_size
    x = torch.from_numpy(np.ascontiguousarray(img))
    if device is not None:
        x = x.to(device)

    base = resize_bicubic_u8(x, t, t)
    ph, pw = select_best_resolution((oh, ow), pinpoints)
    nh, nw = _patch_output_size(oh, ow, ph, pw)
    canvas = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=x.device)
    y0 = (ph - nh) // 2
    x0 = (pw - nw) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = resize_bicubic_u8(x, nh, nw)
    grid = canvas.reshape(ph // t, t, pw // t, t, 3).permute(0, 2, 1, 3, 4) \
        .reshape(-1, t, t, 3)
    tiles = torch.cat([base[None], grid], dim=0)
    if normalize:
        tiles = clip_normalize(tiles)
    return (tiles if device is not None else tiles.numpy()), (oh, ow)
