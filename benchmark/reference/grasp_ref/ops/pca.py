# Frozen copy of leafgrasp_tpu_torch/ops/pca.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Leaf orientation, PyTorch port of leafgrasp_tpu/ops/pca.py: the exact
``cv2.minAreaRect`` of the largest 8-connected component
(``min_area_rect``, the default) and moment PCA (``mask_orientation``).

``min_area_rect`` follows the JAX algorithm step for step: per-row runs
(the leftmost ``rpr`` run starts/ends, ascending), run-graph labels by
min-propagation to a fixed point, the winner's per-row extremes, the
hull by simultaneous reflex deletion to a fixed point, and rotating
calipers. Where JAX relies on ``lax.top_k`` order, the port sorts
(values only, so tie order cannot matter). The two fixed-point loops
are ``while_loop``s in JAX; here each checks convergence with one host
read every ``_CHECK_EVERY`` rounds (extra rounds at a fixed point are
no-ops, so the result is the same). The calipers' projections are
explicit f32 products and sums, not a matmul, so no TF32 path exists.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.grasp_ref.utils.device import host_read

__all__ = ["Orientation", "mask_orientation", "min_area_rect"]

_CHECK_EVERY = 4


class Orientation(NamedTuple):
    angle: torch.Tensor       # radians, direction of the major axis
    major_axis: torch.Tensor
    minor_axis: torch.Tensor
    center: torch.Tensor      # (2,) = (x, y)
    valid: torch.Tensor       # bool


def mask_orientation(mask: torch.Tensor, reduce_fn=None,
                     row0: int = 0) -> Orientation:
    """Major-axis angle / extents / centroid by centered second moments.

    Row-sharded callers pass ``reduce_fn`` (a cross-shard SUM of each
    stacked moment round) and ``row0`` (the frame row of the block's
    first row); the moments stay centered (two rounds), as in JAX."""
    m = mask.to(torch.float32)
    h, w = m.shape
    dev = m.device
    reduce_fn = reduce_fn or (lambda x: x)
    ys = (row0 + torch.arange(h, dtype=torch.float32, device=dev))[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    total, sx, sy = reduce_fn(torch.stack([m.sum(), (m * xs).sum(),
                                           (m * ys).sum()]))
    valid = total > 0
    safe_total = torch.clamp(total, min=1.0)
    mx = sx / safe_total
    my = sy / safe_total
    second = reduce_fn(torch.stack([(m * (xs - mx) ** 2).sum(),
                                    (m * (ys - my) ** 2).sum(),
                                    (m * (xs - mx) * (ys - my)).sum()]))
    dx2, dy2, dxy = second / safe_total
    angle = 0.5 * torch.atan2(2.0 * dxy, dx2 - dy2)
    common = torch.sqrt(torch.clamp((dx2 - dy2) ** 2 / 4.0 + dxy ** 2,
                                    min=0.0))
    lam1 = (dx2 + dy2) / 2.0 + common
    lam2 = (dx2 + dy2) / 2.0 - common
    return Orientation(angle=angle,
                       major_axis=4.0 * torch.sqrt(torch.clamp(lam1, min=0)),
                       minor_axis=4.0 * torch.sqrt(torch.clamp(lam2, min=0)),
                       center=torch.stack([mx, my]), valid=valid)


def _fixed_point(step, state):
    """Apply ``step`` (state -> (state, changed)) until it reports no
    change, reading the flag back every ``_CHECK_EVERY`` rounds."""
    while True:
        changed = None
        for _ in range(_CHECK_EVERY):
            state, ch = step(state)
            changed = ch if changed is None else changed | ch
        if not host_read(changed):
            return state


def _mask_row_runs(m: torch.Tensor, rpr: int):
    """Per-row runs: ([xl, xr] (h, rpr) ascending, padded with w + 1;
    run counts per row)."""
    h, w = m.shape
    rpr = min(rpr, (w + 1) // 2)
    xs = torch.arange(w, dtype=torch.int32, device=m.device)[None, :]
    no_left = torch.zeros_like(m)
    no_left[:, 1:] = m[:, :-1]
    no_right = torch.zeros_like(m)
    no_right[:, :-1] = m[:, 1:]
    starts = m & ~no_left
    ends = m & ~no_right
    inval = torch.full_like(xs.expand(h, w), w + 1)
    xl = torch.sort(torch.where(starts, xs, inval), dim=1).values[:, :rpr]
    xr = torch.sort(torch.where(ends, xs, inval), dim=1).values[:, :rpr]
    return xl, xr, starts.sum(dim=1)


def _largest_component_extremes(m: torch.Tensor, rpr: int,
                                max_runs: int = 512):
    """Per-row [xmin, xmax] of the largest 8-connected component, and
    the validity flag (False on run overflow or an empty mask)."""
    xl, xr, nrow = _mask_row_runs(m, rpr)
    return _largest_component_extremes_from_runs(xl, xr, nrow, m.shape[1],
                                                 max_runs)


def _largest_component_extremes_from_runs(xl, xr, nrow, w: int,
                                          max_runs: int = 512):
    """The frame-wide half of ``_largest_component_extremes``: run-graph
    labels and the winner's per-row extremes from the per-row runs of
    ``_mask_row_runs`` (a row-sharded frame gathers them from its
    shards)."""
    h, rpr = xl.shape
    dev = xl.device
    inval = w + 1
    run_ok = xl < inval
    overflow = (nrow > rpr).any()
    rows_ = torch.arange(h, device=dev)[:, None]
    self_idx = rows_ * rpr + torch.arange(rpr, device=dev)[None]

    def rshift(a, d, fill):
        out = torch.roll(a, d, dims=0)
        out[0 if d > 0 else h - 1] = fill
        return out

    def first_overlap(xl_o, xr_o, ok_o, row_shift):
        ov = (ok_o[:, None, :] & run_ok[:, :, None]
              & (xr_o[:, None, :] >= xl[:, :, None] - 1)
              & (xl_o[:, None, :] <= xr[:, :, None] + 1))    # (h, i, j)
        j = torch.argmax(ov.to(torch.int32), dim=2)
        hit = ov.any(dim=2)
        tgt = (rows_ + row_shift) * rpr + j
        return torch.where(hit, tgt, self_idx)

    up = first_overlap(rshift(xl, 1, inval), rshift(xr, 1, -1),
                       rshift(run_ok, 1, False), -1).reshape(-1)
    dn = first_overlap(rshift(xl, -1, inval), rshift(xr, -1, -1),
                       rshift(run_ok, -1, False), 1).reshape(-1)

    # compact the (h * rpr) slots to the first maxr real runs
    nflat = h * rpr
    maxr = min(max_runs, nflat)
    okf = run_ok.reshape(-1)
    flat_idx = torch.arange(nflat, device=dev)
    cflat = torch.sort(torch.where(okf, flat_idx,
                                   torch.full_like(flat_idx, nflat + 1))
                       ).values[:maxr]
    cok = cflat < nflat
    cclip = torch.where(cok, cflat, torch.zeros_like(cflat))
    # flat -> compact map; invalid compact slots write past the end and
    # are cut off (the JAX scatter drops them)
    lut = torch.zeros(nflat + 2, dtype=torch.int64, device=dev)
    lut[cflat] = torch.arange(maxr, device=dev)
    lut = lut[:nflat]
    cidx = torch.arange(maxr, device=dev)
    up_c = torch.where(cok, lut[up[cclip]], cidx)
    dn_c = torch.where(cok, lut[dn[cclip]], cidx)
    overflow = overflow | (nrow.sum() > maxr)

    def body(lab):
        new = torch.minimum(lab, lab[up_c])
        new = torch.minimum(new, new[dn_c])
        new = new.scatter_reduce(0, up_c, new, reduce="amin")
        new = new.scatter_reduce(0, dn_c, new, reduce="amin")
        new = new[new]
        new = new[new]
        return new, (new != lab).any()

    lab = _fixed_point(body, cidx.clone())

    xl_c = xl.reshape(-1)[cclip]
    xr_c = xr.reshape(-1)[cclip]
    length = torch.where(cok, xr_c - xl_c + 1, torch.zeros_like(xl_c))
    areas = torch.zeros(maxr, dtype=torch.int64, device=dev) \
        .index_add_(0, lab, length.to(torch.int64))
    win = torch.argmax(areas)
    winner = (lab == win) & cok
    crow = cclip // rpr
    bigx = 1 << 20
    xmin_r = torch.full((h,), bigx, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, crow, torch.where(winner, xl_c,
                                             torch.full_like(xl_c, bigx)),
                        reduce="amin")
    xmax_r = torch.full((h,), -1, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, crow, torch.where(winner, xr_c,
                                             torch.full_like(xr_c, -1)),
                        reduce="amax")
    return xmin_r, xmax_r, (nrow > 0).any() & ~overflow


def min_area_rect(mask: torch.Tensor, max_runs_per_row: int = 16,
                  largest_component: bool = True) -> Orientation:
    """``cv2.minAreaRect``-equivalent orientation of the largest
    component (or of the whole mask); the angle is the MAJOR-axis
    direction in radians."""
    m = mask.to(torch.bool)
    h, w = m.shape
    if largest_component:
        xmin_r, xmax_r, valid_m = _largest_component_extremes(
            m, max_runs_per_row)
    else:
        cols = torch.arange(w, dtype=torch.int32, device=m.device)[None, :]
        xmin_r = torch.where(m, cols, torch.full_like(cols, 1 << 20)) \
            .amin(dim=1)
        xmax_r = torch.where(m, cols, torch.full_like(cols, -1)).amax(dim=1)
        valid_m = m.any()
    return _rect_from_row_extremes(xmin_r, xmax_r, w, valid_m)


def _rect_from_row_extremes(xmin_r, xmax_r, w: int, valid_m):
    """Hull by reflex deletion + rotating calipers from per-row extremes."""
    h = xmin_r.shape[0]
    dev = xmin_r.device
    rows = torch.arange(h, dtype=torch.int32, device=dev)
    row_ok = xmax_r >= 0
    cx_ = torch.cat([xmin_r, xmax_r])
    cy_ = torch.cat([rows, rows])
    # single-pixel rows keep only their xmin copy
    cok = torch.cat([row_ok, row_ok & (xmax_r > xmin_r)])
    n = 2 * h
    skey = torch.where(cok, cx_.to(torch.int64) * (h + 1) + cy_,
                       torch.full_like(cx_, 2 ** 31 - 1, dtype=torch.int64))
    order = torch.sort(skey, stable=True).indices
    px, py, pok = cx_[order], cy_[order], cok[order]
    idx = torch.arange(n, device=dev)
    nbig = n + 1

    def neighbors(alive):
        arr = torch.where(alive, idx, torch.full_like(idx, nbig))
        suf = torch.flip(torch.cummin(torch.flip(arr, [0]), 0).values, [0])
        nxt = torch.cat([suf[1:], torch.full_like(suf[:1], nbig)])
        arr2 = torch.where(alive, idx, torch.full_like(idx, -1))
        pre = torch.cummax(arr2, 0).values
        prv = torch.cat([torch.full_like(pre[:1], -1), pre[:-1]])
        return prv, nxt

    def half_hull(sign):
        def body(alive):
            prv, nxt = neighbors(alive)
            interior_pt = alive & (prv >= 0) & (nxt < n)
            pc = torch.clamp(prv, 0, n - 1)
            nc = torch.clamp(nxt, 0, n - 1)
            ax, ay = px[pc], py[pc]
            bx, by = px[nc], py[nc]
            # int32 exact: |coords| < 2^12 -> |cross| < 2^25
            cr = (bx - ax) * (py - ay) - (px - ax) * (by - ay)
            drop = interior_pt & (sign * cr <= 0)
            return alive & ~drop, drop.any()
        return _fixed_point(body, pok)

    up, lo_h = half_hull(1), half_hull(-1)
    hull = up | lo_h

    def edges(alive):
        arr = torch.where(alive, idx, torch.full_like(idx, nbig))
        suf = torch.flip(torch.cummin(torch.flip(arr, [0]), 0).values, [0])
        nxt = torch.cat([suf[1:], torch.full_like(suf[:1], nbig)])
        ok_e = alive & (nxt < n)
        nc = torch.clamp(nxt, 0, n - 1)
        dx = torch.where(ok_e, px[nc] - px, torch.ones_like(px))
        dy = torch.where(ok_e, py[nc] - py, torch.zeros_like(py))
        return dx.to(torch.float32), dy.to(torch.float32)

    dxu, dyu = edges(up)
    dxl, dyl = edges(lo_h)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    dx = torch.cat([dxu, dxl, one])
    dy = torch.cat([dyu, dyl, torch.zeros_like(one)])
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy)
    c, s = dx * inv, dy * inv                                  # (E,)

    # projections of every hull candidate on each edge direction and its
    # normal, in true f32 (the JAX matmul runs at Precision.HIGHEST)
    pxf = px.to(torch.float32)[:, None]
    pyf = py.to(torch.float32)[:, None]
    dirs_x = torch.cat([c, -s])
    dirs_y = torch.cat([s, c])
    proj = pxf * dirs_x[None, :] + pyf * dirs_y[None, :]       # (N, 2E)
    big = float(2 * (h + w))
    hf = hull[:, None]
    lo = torch.where(hf, proj, torch.full_like(proj, big)).amin(dim=0)
    hi = torch.where(hf, proj, torch.full_like(proj, -big)).amax(dim=0)
    e = dx.shape[0]
    wid, hei = (hi - lo)[:e], (hi - lo)[e:]
    best = torch.argmin(wid * hei)

    theta = torch.atan2(dy[best], dx[best])
    rw, rh = wid[best], hei[best]
    cu = (lo[best] + hi[best]) / 2
    cv = (lo[e + best] + hi[e + best]) / 2
    cb, sb = torch.cos(theta), torch.sin(theta)
    center = torch.stack([cu * cb - cv * sb, cu * sb + cv * cb])
    angle = torch.where(rw >= rh, theta, theta + math.pi / 2)
    return Orientation(angle=angle, major_axis=torch.maximum(rw, rh),
                       minor_axis=torch.minimum(rw, rh), center=center,
                       valid=valid_m)
