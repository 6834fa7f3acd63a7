# Frozen copy of leafgrasp_tpu_torch/kernels/histogram.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
# The kernel wrapper always takes its plain PyTorch version.
"""Per-segment depth histogram: the kernel wrapper and its plain version.

    out[r, id, bin] = number of pixels with that id whose
                      bin == int(clip((depth - lo[r, id]) * inv_w[r, id],
                                      0, 255))

for f32 ``depth`` and integer ``ids`` of one shape, and f32 brackets
``lo`` / ``inv_w`` of shape (num,), which gives (num, 256) counts, or
(R, num) with R at most 2, which gives (R, num, 256): R brackets over one
read of the pixels, as the two-level median asks for its two order
statistics. Ids outside ``[0, num)`` count nowhere. Replaces the TPU
kernel ``segment_histogram`` (leafgrasp_tpu/ops/pallas_median.py:76),
whose call is the (num,) form; each slice of the (R, num) form is one such
call. The kernel source, with its bound and design, is
``csrc/histogram.cu``. Counts are integers, returned as f32 and exact
while the pixel count is at most 2^24 (the kernel adds them in f32), so
kernel and plain version agree exactly.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels import LAUNCHES

__all__ = ["segment_histogram", "segment_histogram_plain", "NBINS",
           "MAX_BRACKETS"]

NBINS = 256            # HIST_BINS in the kernel
MAX_BRACKETS = 2       # R
_THREADS = 1024        # HIST_THREADS in the kernel
_PPT = 8               # HIST_PPT: pixels of a group (two 16-byte vectors)
_BLOCKS_PER_SM = 1     # the grid the launcher aims at: one block an SM
_MAX_SEGMENTS = 222    # R * num: (R, num, 256) int32 counts and the
#                        (R, num) brackets within 227 KB of shared memory
_MAX_PIXELS = 1 << 24  # f32 counts stay exact


def _check_args(depth, ids, lo, inv_w, num) -> int:
    """Raise on what neither version takes; return R (0 for (num,))."""
    if depth.dtype != torch.float32:
        raise ValueError(f"depth must be float32, got {depth.dtype}")
    if ids.dtype not in (torch.int32, torch.int64, torch.int16):
        raise ValueError(f"ids must be an integer tensor, got {ids.dtype}")
    if ids.shape != depth.shape:
        raise ValueError(f"depth {tuple(depth.shape)} and ids "
                         f"{tuple(ids.shape)} differ in shape")
    if num < 1:
        raise ValueError(f"num must be positive, got {num}")
    if lo.dim() == 2 and not 1 <= lo.shape[0] <= MAX_BRACKETS:
        raise ValueError(f"lo holds {lo.shape[0]} brackets; the kernel "
                         f"takes 1 to {MAX_BRACKETS}")
    want = (num,) if lo.dim() == 1 else (lo.shape[0], num)
    for name, t in (("lo", lo), ("inv_w", inv_w)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be float32 {want}, the brackets "
                             f"of {num} segments, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != depth.device:
            raise ValueError(f"{name} and depth on different devices")
    if ids.device != depth.device:
        raise ValueError("ids and depth on different devices")
    return 0 if lo.dim() == 1 else lo.shape[0]


def segment_histogram_plain(depth: torch.Tensor, ids: torch.Tensor,
                            lo: torch.Tensor, inv_w: torch.Tensor,
                            num: int) -> torch.Tensor:
    """Plain PyTorch version: one ``bincount`` over
    ``(r * num + id) * 256 + bin``."""
    r = _check_args(depth, ids, lo, inv_w, num)
    lo2, iw2 = (lo, inv_w) if r else (lo[None], inv_w[None])
    rr = lo2.shape[0]
    ids = ids.reshape(-1).to(torch.int64)
    d = depth.reshape(-1)
    valid = (ids >= 0) & (ids < num)
    idc = torch.clamp(ids, 0, num - 1)
    bins = torch.clamp((d[None] - lo2[:, idc]) * iw2[:, idc], 0.0,
                       float(NBINS - 1)).to(torch.int64)        # (R, n)
    cells = rr * num * NBINS
    seg = torch.arange(rr, device=d.device)[:, None] * num + idc[None]
    key = torch.where(valid[None], seg * NBINS + bins,
                      torch.full_like(bins, cells))
    counts = torch.bincount(key.reshape(-1), minlength=cells + 1)[:cells]
    out = counts.reshape(rr, num, NBINS).to(torch.float32)
    return out if r else out[0]


def _blocks(groups: int, device) -> int:
    """The grid: ``_BLOCKS_PER_SM`` blocks an SM, fewer where the frame
    gives a block's threads less than a group of 8 pixels each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * _BLOCKS_PER_SM, -(-groups // _THREADS)))


def segment_histogram(depth: torch.Tensor, ids: torch.Tensor,
                      lo: torch.Tensor, inv_w: torch.Tensor,
                      num: int) -> torch.Tensor:
    """(num, 256) or (R, num, 256) f32 counts: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. On the card int32 ids,
    contiguous inputs and contiguous brackets cost no launch besides the
    kernel's own (and the zeroing of the output inside its entry point);
    ids whose offset from a 16-byte boundary differs from depth's are
    copied first."""
    if depth.device.type in ("cpu", "cuda"):
        return segment_histogram_plain(depth, ids, lo, inv_w, num)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    r = _check_args(depth, ids, lo, inv_w, num)
    rr = max(r, 1)
    if rr * num > _MAX_SEGMENTS:
        raise ValueError(f"the kernel holds at most {_MAX_SEGMENTS} "
                         f"segments times brackets in shared memory, got "
                         f"{rr} x {num}")
    n = depth.numel()
    if n > _MAX_PIXELS:
        raise ValueError(f"{n} pixels: counts past 2^24 would not be exact "
                         f"in the f32 output")
    depth = depth.reshape(-1).contiguous()
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    if depth.data_ptr() % 16 != ids.data_ptr() % 16:
        depth = depth.clone() if depth.data_ptr() % 16 else depth
        ids = ids.clone() if ids.data_ptr() % 16 else ids
    lo, inv_w = lo.contiguous(), inv_w.contiguous()
    out = torch.empty((rr, num, NBINS), dtype=torch.float32,
                      device=depth.device)
    lib = load_library()
    err = lib.segment_histogram(
        depth.data_ptr(), ids.data_ptr(), lo.data_ptr(), inv_w.data_ptr(),
        n, num, rr, _blocks(n // _PPT, depth.device), out.data_ptr(),
        torch.cuda.current_stream(depth.device).cuda_stream)
    check(err, "segment_histogram")
    if n:
        LAUNCHES["segment_histogram"] += 1
    return out if r else out[0]
