# Frozen copy of leafgrasp_tpu_torch/ops/components.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Per-leaf reductions over an instance-id map, PyTorch port of
leafgrasp_tpu/ops/components.py.

The JAX version avoids scatters with one-hot (6, 18, H, W) sums and
(2, 18, H, W) compares that XLA fuses away; eager PyTorch would
materialize them (~670 MB at 1080 x 1440), so here every statistic is a
segment reduction: a ``scatter_add_`` into one row of bins per image
row, then a sum over rows. One flat ``index_add_`` would send every
pixel to one of the ~18 bins, and on CUDA those atomics collide;
``bincount`` avoids that but reads its largest id back to the host.

Sums accumulate in float64 and round once to float32; bisection counts
are int64. Pixel counts, coordinate sums and counts are exact integers,
so areas, centroids, medians and border flags match the JAX package bit
for bit, while the depth and ray-norm means may differ from its float32
tree sums by a few ulps (relative ~1e-7). On CUDA the float64 sums are
atomic adds in no fixed order, which can move a mean by one f32 ulp in
rare cases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.grasp_ref.ops.median import masked_median_hist

__all__ = ["LeafStats", "leaf_stats", "masked_median",
           "masked_median_range"]


class LeafStats(NamedTuple):
    """Per-leaf statistics, index 0 <-> leaf id 1. All tensors (L,)."""

    area: torch.Tensor           # int32 pixel counts
    centroid_x: torch.Tensor     # float32
    centroid_y: torch.Tensor     # float32
    mean_depth: torch.Tensor     # float32
    median_depth: torch.Tensor   # float32 (bisection, or the histogram)
    mean_ray_norm: torch.Tensor  # float32
    border_contact: torch.Tensor  # bool
    present: torch.Tensor        # bool


def _segment_sum(ids: torch.Tensor, values: torch.Tensor,
                 num: int) -> torch.Tensor:
    """(num,) sums of ``values`` grouped by the (H, W') int64 ``ids``,
    in the dtype of ``values``: per-row bins, then a sum over rows."""
    rows = torch.zeros((ids.shape[0], num), dtype=values.dtype,
                       device=ids.device)
    return rows.scatter_add_(1, ids, values).sum(dim=0)


def masked_median(depth: torch.Tensor, ids: torch.Tensor,
                  counts: torch.Tensor, num: int, iters: int = 18,
                  reduce_fn=None, depth_range=None) -> torch.Tensor:
    """Per-segment median of ``depth`` grouped by ``ids`` by vectorized
    bisection on [min(depth), max(depth)] (numpy semantics: the average
    of the two middle order statistics for even counts).

    Row-sharded callers pass ``reduce_fn`` (a cross-shard SUM, applied
    to every round's counts) and the frame's ``depth_range`` (dmin,
    dmax), globally reduced; ``counts`` are then the global counts."""
    cnt = counts.to(torch.int64)
    # 0-based order statistics to extract, stacked (2, num)
    ks = torch.stack([torch.clamp(cnt - 1, min=0) // 2, cnt // 2])
    if depth_range is None:
        dmin, dmax = depth.min(), depth.max()
    else:
        dmin, dmax = depth_range
    lo = torch.as_tensor(dmin, device=depth.device) \
        .to(torch.float32).expand(2, num).clone()
    hi = torch.as_tensor(dmax, device=depth.device) \
        .to(torch.float32).expand(2, num).clone()
    ids = ids.to(torch.int64)
    # one integer segment count per round over both statistics: the
    # segment of pixel p for statistic s is ids[p] + s * num
    both = torch.cat([ids, ids + num], dim=1)                 # (H, 2W)
    depth2 = torch.cat([depth, depth], dim=1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)                                 # (2, num)
        le = depth2 <= mid.reshape(-1)[both]
        cnt_le = _segment_sum(both, le.to(torch.int64), 2 * num)
        if reduce_fn is not None:
            cnt_le = reduce_fn(cnt_le)
        go_left = cnt_le.reshape(2, num) >= ks + 1
        hi = torch.where(go_left, mid, hi)
        lo = torch.where(go_left, lo, mid)
    return 0.5 * (hi[0] + hi[1])


def masked_median_range(depth: torch.Tensor, ids: torch.Tensor,
                        counts: torch.Tensor, num: int, dmin, dmax,
                        iters: int = 18, reduce_fn=None) -> torch.Tensor:
    """``masked_median`` with an explicit bisection range [dmin, dmax]
    (callers in sharded bodies supply globally reduced extrema)."""
    return masked_median(depth, ids, counts, num, iters=iters,
                         reduce_fn=reduce_fn, depth_range=(dmin, dmax))


def leaf_stats(mask_ids: torch.Tensor, depth: torch.Tensor,
               max_leaves: int, camera_cx, camera_cy, f_norm,
               hist_median: bool = False, reduce_fn=None, row0: int = 0,
               frame_height: int | None = None,
               depth_range=None) -> LeafStats:
    """All per-leaf statistics of an (H, W) instance map (0 = background,
    ids above ``max_leaves`` go to an overflow bucket) and f32 depth.
    ``camera_cx/cy``/``f_norm`` are f32 0-dim tensors or numbers.

    ``hist_median`` takes the medians from the two-level histogram
    (ops/median.py, two launches of the segment histogram kernel)
    instead of the 18-round bisection; the two agree within
    range / 256^2, not bit for bit, so the bisection is the default (the
    counterpart of the JAX package's ``use_pallas`` argument here).

    Row-sharded callers (parallel/spatial_frame.py) pass the block of
    rows they hold with ``reduce_fn`` (a cross-shard SUM of every
    per-leaf partial sum: the float64 sums, then every bisection
    round's counts), ``row0`` (the frame row of the block's first row),
    ``frame_height`` (for the bottom-border row) and ``depth_range``
    (the frame's (dmin, dmax), globally reduced, required with
    ``reduce_fn``). The float64 partial sums round once to float32
    after the reduction, so a sharded mean equals the unsharded one
    unless the sums' order moves a float64 rounding across a float32
    one."""
    h, w = mask_ids.shape
    dev = mask_ids.device
    fh = h if frame_height is None else frame_height
    num_seg = max_leaves + 2  # 0 = background, 1..L = leaves, L+1 overflow
    if reduce_fn is not None and (depth_range is None or hist_median):
        raise ValueError("reduce_fn needs depth_range and the bisection "
                         "median")

    ids = mask_ids.to(torch.int64)
    ids = torch.where(ids > max_leaves, torch.full_like(ids, max_leaves + 1),
                      torch.clamp(ids, min=0))
    depth = depth.to(torch.float32)

    ys = (row0 + torch.arange(h, dtype=torch.float32, device=dev))[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ray_norm = torch.sqrt((xs - camera_cx) ** 2 + (ys - camera_cy) ** 2
                          + f_norm * f_norm)
    ys_i = row0 + torch.arange(h, device=dev)[:, None]
    border = ((ys_i == 0) | (ys_i == fh - 1)).expand(h, w).clone()
    border[:, 0] = True
    border[:, -1] = True

    def seg_sum(values):
        return _segment_sum(ids, values.expand(h, w).to(torch.float64),
                            num_seg)

    sums = torch.stack([seg_sum(v) for v in (
        torch.ones_like(depth), xs, ys, depth, ray_norm, border)])
    if reduce_fn is not None:
        sums = reduce_fn(sums)
    area_all, sum_x, sum_y, sum_depth, sum_ray, border_counts = sums
    area_f = area_all.to(torch.float32)
    safe_area = torch.clamp(area_f, min=1.0)
    if hist_median:
        median_all = masked_median_hist(depth, ids, area_all, num_seg)
    else:
        median_all = masked_median(depth, ids, area_all, num_seg,
                                   reduce_fn=reduce_fn,
                                   depth_range=depth_range)

    sl = slice(1, max_leaves + 1)
    area = area_all[sl].to(torch.int32)

    def mean(total):
        return total.to(torch.float32)[sl] / safe_area[sl]

    return LeafStats(
        area=area,
        centroid_x=mean(sum_x),
        centroid_y=mean(sum_y),
        mean_depth=mean(sum_depth),
        median_depth=median_all[sl],
        mean_ray_norm=mean(sum_ray),
        border_contact=border_counts[sl] > 0,
        present=area > 0,
    )
