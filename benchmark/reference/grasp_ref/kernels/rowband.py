# Frozen copy of leafgrasp_tpu_torch/kernels/rowband.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
# The kernel wrapper always takes its plain PyTorch version.
"""Row-banded EDT pass 2: the kernel wrapper and its plain version.

    out[c, i, j] = min over i' of g2r[c, i', j] + (i - i')^2

for f32 ``g2r`` (C, H, W), the squared per-ROW distances of a horizontal
pass 1. Replaces the TPU kernel ``squared_edt_rowband``
(leafgrasp_tpu/ops/pallas_edt.py:215); the kernel source, with its bound
and design, is ``csrc/rowband.cu``. The kernel visits, per 8 x 128
output tile, only the candidate rows within the tile's radius ``nb``,
which its first launch derives from an 8-row pooled upper bound; the
plain version sweeps every row. The kernel's second launch merges the
partial minima of a tile's pieces of work by an atomic minimum on the
bits, so on the card ``g2r`` holds non-negative values or ``+inf`` (the
squared distances it is made for). Values are integer-valued f32 and any
pointwise upper bound gives an exact band, so kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels import LAUNCHES

__all__ = ["squared_edt_rowband", "squared_edt_rowband_plain",
           "rowband_radii_plain", "TILE_ROWS", "TILE_COLS"]

TILE_ROWS = 8      # output rows of a tile (RB_ROWS in the kernel)
TILE_COLS = 128    # output columns of a tile (RB_COLS in the kernel)

# elements of the (rows, H, W) candidate block the plain version builds
_PLAIN_BLOCK = 1 << 25


def _check_args(g2r):
    if g2r.dtype != torch.float32 or g2r.dim() != 3:
        raise ValueError(f"g2r must be (C, H, W) float32, got {g2r.dtype} "
                         f"{tuple(g2r.shape)}")
    if 0 in g2r.shape:
        raise ValueError(f"g2r has an empty dimension: {tuple(g2r.shape)}")


def squared_edt_rowband_plain(g2r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the full sweep over all candidate rows,
    chunked over output rows so the (rows, H, W) candidate block stays
    bounded."""
    _check_args(g2r)
    c, h, w = g2r.shape
    idx = torch.arange(h, dtype=torch.float32, device=g2r.device)
    step = max(1, _PLAIN_BLOCK // (h * w))
    out = torch.empty_like(g2r)
    for ci in range(c):
        for i0 in range(0, h, step):
            d = idx[i0:i0 + step, None] - idx[None, :]          # (rows, H)
            cand = g2r[ci][None, :, :] + (d * d)[:, :, None]    # (rows, H, W)
            out[ci, i0:i0 + step] = cand.amin(dim=1)
    return out


def rowband_radii_plain(g2r: torch.Tensor) -> torch.Tensor:
    """The per-tile row radii as the kernel's first launch computes them:
    int32 (C, ceil(H/8), ceil(W/128)). Pool each tile's rows by min,
    solve the min-plus at 1/8 row resolution with the offset
    ``(8 (|I - I'| + 1))^2`` (an upper bound of every output of row tile
    I), take each tile's maximum over its columns, and
    ``nb = floor(sqrt(max)) + 1``, at most H."""
    _check_args(g2r)
    c, h, w = g2r.shape
    rt, ct = -(-h // TILE_ROWS), -(-w // TILE_COLS)
    inf = float("inf")
    g2c = torch.nn.functional.pad(g2r, (0, 0, 0, rt * TILE_ROWS - h),
                                  value=inf) \
        .reshape(c, rt, TILE_ROWS, w).amin(dim=2)               # (C, RT, W)
    blk = torch.arange(rt, device=g2r.device)
    upper = torch.full_like(g2c, inf)
    for k in range(rt):
        off = ((blk - k).abs() + 1) * TILE_ROWS
        off = (off * off).to(torch.float32)                     # (RT,)
        upper = torch.minimum(upper, g2c[:, k:k + 1, :] + off[None, :, None])
    # columns past W bound nothing
    upper = torch.nn.functional.pad(upper, (0, ct * TILE_COLS - w),
                                    value=0.0)
    tile_max = upper.reshape(c, rt, ct, TILE_COLS).amax(dim=3)
    # a root at or above H clamps to H (+inf included)
    tile_max = torch.clamp(tile_max.to(torch.float64), max=float(h) * h)
    nb = torch.sqrt(tile_max).to(torch.int32) + 1
    return torch.clamp(nb, max=h)


def squared_edt_rowband(g2r: torch.Tensor, return_radii: bool = False):
    """The min-plus above: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. With ``return_radii`` also the int32
    (C, ceil(H/8), ceil(W/128)) row radii the tiles were given."""
    if g2r.device.type in ("cpu", "cuda"):
        out = squared_edt_rowband_plain(g2r)
        return (out, rowband_radii_plain(g2r)) if return_radii else out
    if g2r.device.type != "cuda":
        raise ValueError(f"unsupported device {g2r.device}")
    _check_args(g2r)
    g2r = g2r.contiguous()
    c, h, w = g2r.shape
    rt, ct = -(-h // TILE_ROWS), -(-w // TILE_COLS)
    dev = g2r.device
    nb4 = torch.empty((c, rt, ct, 4), dtype=torch.int32, device=dev)
    nb = torch.empty((c, rt, ct), dtype=torch.int32, device=dev)
    out = torch.empty_like(g2r)
    lib = load_library()
    err = lib.squared_edt_rowband(
        g2r.data_ptr(), c, h, w, nb4.data_ptr(), nb.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "squared_edt_rowband")
    LAUNCHES["squared_edt_rowband"] += 1
    return (out, nb) if return_radii else out
