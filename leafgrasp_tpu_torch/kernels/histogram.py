"""Per-segment depth histogram: the kernel wrapper and its plain version.

    out[id, bin] = number of pixels with that id whose
                   bin == int(clip((depth - lo[id]) * inv_w[id], 0, 255))

for f32 ``depth`` and integer ``ids`` of one shape, and f32 ``lo`` /
``inv_w`` (num,). Ids outside ``[0, num)`` count nowhere. Replaces the
TPU kernel ``segment_histogram`` (leafgrasp_tpu/ops/pallas_median.py:76);
the kernel source, with its bound and design, is ``csrc/histogram.cu``.
Counts are integers (returned as f32, below 2^24), so kernel and plain
version agree exactly.
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["segment_histogram", "segment_histogram_plain", "NBINS"]

NBINS = 256            # HIST_BINS in the kernel
_THREADS = 256         # HIST_THREADS in the kernel
_MAX_BLOCKS = 132 * 8  # a few blocks per SM; each flushes num * 256 bins
_MAX_SEGMENTS = 222    # (num, 256) int32 within 227 KB of shared memory


def _check_args(depth, ids, lo, inv_w, num):
    if depth.dtype != torch.float32:
        raise ValueError(f"depth must be float32, got {depth.dtype}")
    if ids.dtype not in (torch.int32, torch.int64, torch.int16):
        raise ValueError(f"ids must be an integer tensor, got {ids.dtype}")
    if ids.shape != depth.shape:
        raise ValueError(f"depth {tuple(depth.shape)} and ids "
                         f"{tuple(ids.shape)} differ in shape")
    if num < 1:
        raise ValueError(f"num must be positive, got {num}")
    for name, t in (("lo", lo), ("inv_w", inv_w)):
        if t.dtype != torch.float32 or tuple(t.shape) != (num,):
            raise ValueError(f"{name} must be float32 ({num},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != depth.device:
            raise ValueError(f"{name} and depth on different devices")
    if ids.device != depth.device:
        raise ValueError("ids and depth on different devices")


def segment_histogram_plain(depth: torch.Tensor, ids: torch.Tensor,
                            lo: torch.Tensor, inv_w: torch.Tensor,
                            num: int) -> torch.Tensor:
    """Plain PyTorch version: one ``bincount`` over ``id * 256 + bin``."""
    _check_args(depth, ids, lo, inv_w, num)
    ids = ids.reshape(-1).to(torch.int64)
    d = depth.reshape(-1)
    valid = (ids >= 0) & (ids < num)
    idc = torch.clamp(ids, 0, num - 1)
    bins = torch.clamp((d - lo[idc]) * inv_w[idc], 0.0, float(NBINS - 1)) \
        .to(torch.int64)
    cells = num * NBINS
    key = torch.where(valid, idc * NBINS + bins,
                      torch.full_like(ids, cells))
    counts = torch.bincount(key, minlength=cells + 1)[:cells]
    return counts.reshape(num, NBINS).to(torch.float32)


def segment_histogram(depth: torch.Tensor, ids: torch.Tensor,
                      lo: torch.Tensor, inv_w: torch.Tensor,
                      num: int) -> torch.Tensor:
    """(num, 256) f32 counts: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if depth.device.type == "cpu":
        return segment_histogram_plain(depth, ids, lo, inv_w, num)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    _check_args(depth, ids, lo, inv_w, num)
    if num > _MAX_SEGMENTS:
        raise ValueError(f"the kernel holds at most {_MAX_SEGMENTS} "
                         f"segments in shared memory, got {num}")
    depth = depth.contiguous()
    ids = ids.to(torch.int32).contiguous()
    lo, inv_w = lo.contiguous(), inv_w.contiguous()
    n = depth.numel()
    out = torch.zeros((num, NBINS), dtype=torch.int32, device=depth.device)
    if n:
        blocks = min(_MAX_BLOCKS, -(-n // _THREADS))
        lib = load_library()
        err = lib.segment_histogram(
            depth.data_ptr(), ids.data_ptr(), lo.data_ptr(),
            inv_w.data_ptr(), n, num, blocks, out.data_ptr(),
            torch.cuda.current_stream(depth.device).cuda_stream)
        check(err, "segment_histogram")
        LAUNCHES["segment_histogram"] += 1
    return out.to(torch.float32)
