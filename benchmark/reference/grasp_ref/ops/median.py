# Frozen copy of leafgrasp_tpu_torch/ops/median.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Per-leaf median by a two-level histogram, PyTorch port of
leafgrasp_tpu/ops/pallas_median.py.

Instead of the 18-round bisection of ``ops/components.masked_median``
(one pass over the frame per round), two launches of the segment
histogram kernel (kernels/histogram.py): one 256-bin per-leaf histogram
over [min(depth), max(depth)] shared by the two order statistics, then
one launch that refines each statistic's bin, both brackets over one read
of the frame (the JAX package makes these two histograms in two calls;
each slice here is one of those calls). Final precision:
range / 256^2 / 2 < 1e-5 m, the envelope of the bisection. The result is
within that envelope of the bisection's, not bit for bit, so callers ask
for it (``leaf_stats(..., hist_median=True)``); the bisection stays the
default.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels.histogram import NBINS, segment_histogram

__all__ = ["segment_histogram", "masked_median_hist", "NBINS"]


def _refine(hist: torch.Tensor, k: torch.Tensor, lo: torch.Tensor,
            width: torch.Tensor):
    """Locate the bin of each 0-based GLOBAL rank ``k``; return
    (new_lo, new_width). Ranks stay global across levels: elements
    outside the bracket clip into the edge bins but keep their sorted
    order, so cumulative counts remain consistent with the global rank.
    ``hist`` (..., num, NBINS) broadcasts against ``k`` (..., num)."""
    csum = torch.cumsum(hist, dim=-1)                      # (..., NBINS)
    gt = csum > k[..., None].to(csum.dtype)
    b = torch.argmax(gt.to(torch.uint8), dim=-1)           # first bin > k
    new_w = width / NBINS
    return lo + b.to(torch.float32) * new_w, new_w


def masked_median_hist(depth: torch.Tensor, ids: torch.Tensor,
                       counts: torch.Tensor, num: int) -> torch.Tensor:
    """Drop-in for ``components.masked_median`` through the histogram
    kernel (numpy semantics: the average of the two middle order
    statistics for even counts)."""
    depth = depth.to(torch.float32)
    ids = ids.to(torch.int32)
    dmin = depth.min()
    dmax = depth.max()
    span = torch.clamp(dmax - dmin, min=1e-12)

    cnt = counts.to(torch.int32)
    # the two order statistics, (2, num)
    ks = torch.stack([torch.clamp(cnt - 1, min=0) // 2, cnt // 2]) \
        .to(torch.float32)

    # level 1 is shared between the two ranks
    lo = dmin.expand(num).contiguous()
    width = span.expand(num).contiguous()
    hist1 = segment_histogram(depth, ids, lo, NBINS / width, num)
    lo2, w2 = _refine(hist1, ks, lo, width)                # (2, num)
    w2 = w2.expand_as(lo2)
    # level 2: each rank's bracket, both in one launch
    hist2 = segment_histogram(depth, ids, lo2, NBINS / w2, num)
    lo3, w3 = _refine(hist2, ks, lo2, w2)
    mid = lo3 + 0.5 * w3                                   # bin midpoints
    return 0.5 * (mid[0] + mid[1])
