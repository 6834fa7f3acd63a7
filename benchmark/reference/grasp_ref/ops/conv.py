# Frozen copy of leafgrasp_tpu_torch/ops/conv.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Small separable convolutions, PyTorch port of
leafgrasp_tpu/ops/conv.py: reflect-padded Gaussian smoothing, Sobel
gradients and flatness, as shifted multiply-adds in the JAX package's
term order (so the f32 sums round the same way).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_taps_1d", "gaussian_kernel", "SOBEL_X", "SOBEL_Y",
           "reflect_conv2d", "separable_conv2d_reflect", "smooth_depth",
           "sobel_gradients", "gradient_magnitude", "flatness_from_depth"]

# the Sobel operator's two factors (grasp_point_selector.py:646-651)
_SMOOTH_TAPS = (1.0, 2.0, 1.0)
_DIFF_TAPS = (-1.0, 0.0, 1.0)
SOBEL_X = np.outer(_SMOOTH_TAPS, _DIFF_TAPS).astype(np.float32)
SOBEL_Y = SOBEL_X.T.copy()


@functools.lru_cache(maxsize=8)
def gaussian_taps_1d(size: int):
    """1D factor of the isotropic Gaussian (normalized)."""
    sigma = size / 6.0
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32))


def gaussian_kernel(size: int) -> np.ndarray:
    """Normalized 2D Gaussian with sigma = size/6 (reference
    image_processor.py:25-32): the outer product of its 1D factor."""
    taps = np.asarray(gaussian_taps_1d(size), np.float32)
    return np.outer(taps, taps)


def reflect_conv2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlate (H, W) with a small 2D kernel under reflect padding
    (torch ``F.pad(mode='reflect')`` + ``F.conv2d``, as the reference
    calls them: image_processor.py:60-64)."""
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=img.device)
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    padded = F.pad(img.to(torch.float32)[None, None], (pw, pw, ph, ph),
                   mode="reflect")
    return F.conv2d(padded, k[None, None])[0, 0]


def _conv1d_reflect(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1D correlation along ``axis`` under reflect padding."""
    taps = np.asarray(taps, np.float32).ravel()
    p = len(taps) // 2
    pad = (p, p, 0, 0) if axis == 1 else (0, 0, p, p)
    padded = F.pad(img.to(torch.float32)[None], pad, mode="reflect")[0]
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        sl = padded[:, i:i + n] if axis == 1 else padded[i:i + n]
        term = sl * float(t)
        out = term if out is None else out + term
    return out


def separable_conv2d_reflect(img: torch.Tensor, col_taps,
                             row_taps) -> torch.Tensor:
    """2D correlation with kernel = outer(col_taps, row_taps)."""
    return _conv1d_reflect(_conv1d_reflect(img, col_taps, 0), row_taps, 1)


def smooth_depth(depth: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Gaussian depth smoothing (reference image_processor.py:56-64)."""
    taps = gaussian_taps_1d(size)
    return separable_conv2d_reflect(depth, taps, taps)


def sobel_gradients(img: torch.Tensor):
    """(dx, dy) Sobel gradients with reflect padding
    (grasp_point_selector.py:646-651)."""
    dx = separable_conv2d_reflect(img, _SMOOTH_TAPS, _DIFF_TAPS)
    dy = separable_conv2d_reflect(img, _DIFF_TAPS, _SMOOTH_TAPS)
    return dx, dy


def gradient_magnitude(masked_depth: torch.Tensor,
                       gaussian_size: int = 5) -> torch.Tensor:
    """|grad(smooth(depth))|, the flatness input."""
    dx, dy = sobel_gradients(smooth_depth(masked_depth, gaussian_size))
    return torch.sqrt(dx * dx + dy * dy)


def flatness_from_depth(masked_depth: torch.Tensor, scale: float = 5.0,
                        gaussian_size: int = 5) -> torch.Tensor:
    """exp(-|grad(smooth(depth))| * scale)
    (reference grasp_point_selector.py:635-657)."""
    return torch.exp(-gradient_magnitude(masked_depth, gaussian_size)
                     * scale)
