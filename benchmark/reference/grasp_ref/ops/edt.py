# Frozen copy of leafgrasp_tpu_torch/ops/edt.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Exact Euclidean distance transform (EDT), PyTorch port of
leafgrasp_tpu/ops/edt.py.

1. per-column 1D distance to the nearest seed, by running max/min of
   seed indices (``cummax`` / ``cummin`` in place of
   ``lax.associative_scan``), giving G[i, j];
2. exact 2D squared distance D2[i, j] = min_j' (G[i, j']^2 + (j - j')^2),
   a min-plus along rows. Every min-plus here goes through the
   ``minplus_pass2`` kernel (kernels/minplus.py): all columns, a query
   window, the envelope's sampled columns, per-row refinement windows,
   or the banded sweep.

``_pass2`` states the frame's sentinel ``(H + W)^2`` to the kernel,
which picks its form from it and rounds as the JAX package does at every
frame size (see kernels/minplus.py), so each result is bit for bit the
JAX package's, past 2^24 too (a seedless frame's sentinel). The
data-dependent choices of the JAX version (banded vs full sweep, the
envelope coverage guard) are Python branches on a scalar read back with
``host_read``.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels.minplus import (BAND_COLS, BAND_ROWS,
                                                 minplus_pass2)
from benchmark.reference.grasp_ref.kernels.rowband import squared_edt_rowband
from benchmark.reference.grasp_ref.utils.device import host_read

__all__ = ["nearest_seed_dist_1d", "directional_seed_dist_1d",
           "squared_edt", "squared_edt_full", "squared_edt_window",
           "squared_edt_window_src", "edt", "edt_max_argmax",
           "edt_max_argmax_batch", "shift_cols", "exact_sqrt", "edt_batch",
           "edt_batch_rowband", "signed_edt"]


def exact_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root of (integer-valued) squared
    distances. torch's vectorized f32 sqrt on AVX-512 CPUs is not
    correctly rounded (one ulp off for ~20% of integers below 4M); its
    f64 sqrt is, and rounding a correctly rounded f64 root to f32 is
    itself correctly rounded, so CPU and CUDA agree bit for bit."""
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def directional_seed_dist_1d(seeds: torch.Tensor, axis: int = 0):
    """(d_before, d_after) int32: distance along ``axis`` to the nearest
    True seed at-or-before / at-or-after each position; the sentinel
    ``H + W`` (last two dims) where there is none."""
    seeds = seeds.to(torch.bool)
    axis = axis % seeds.dim()
    n = seeds.shape[axis]
    big = seeds.shape[-2] + seeds.shape[-1]
    view = [1] * seeds.dim()
    view[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=seeds.device) \
        .view(view).expand(seeds.shape)

    before = torch.where(seeds, idx, torch.full_like(idx, -1))
    before = torch.cummax(before, dim=axis).values
    d_before = torch.where(before >= 0, idx - before,
                           torch.full_like(idx, big))

    after = torch.where(seeds, idx, torch.full_like(idx, 2 * n))
    after = torch.flip(torch.cummin(torch.flip(after, [axis]),
                                    dim=axis).values, [axis])
    d_after = torch.where(after < 2 * n, after - idx,
                          torch.full_like(idx, big))
    return d_before, d_after


def nearest_seed_dist_1d(seeds: torch.Tensor, axis: int = 0) -> torch.Tensor:
    d_before, d_after = directional_seed_dist_1d(seeds, axis=axis)
    return torch.minimum(d_before, d_after)


def _pass2(g2: torch.Tensor, h: int, **kw) -> torch.Tensor:
    """The min-plus over rows ``g2`` (R, W) of the pass-1 field of a
    frame ``h`` rows tall, with the field's largest finite value, the
    sentinel ``(h + W)^2``, stated to the kernel."""
    w = g2.shape[-1]
    return minplus_pass2(g2.contiguous(), g2_max=(h + w) ** 2, **kw)


def _pass1_g2(seeds: torch.Tensor) -> torch.Tensor:
    g = nearest_seed_dist_1d(seeds, axis=-2).to(torch.float32)
    return g * g


def shift_cols(arr: torch.Tensor, delta: int, fill) -> torch.Tensor:
    """out[..., j] = arr[..., j + delta], ``fill`` where out of bounds."""
    if delta == 0:
        return arr
    pad = torch.full((*arr.shape[:-1], abs(delta)), fill, dtype=arr.dtype,
                     device=arr.device)
    if delta > 0:
        return torch.cat([arr[..., delta:], pad], dim=-1)
    return torch.cat([pad, arr[..., :delta]], dim=-1)


def squared_edt_full(seeds: torch.Tensor | None,
                     g2: torch.Tensor | None = None) -> torch.Tensor:
    """Exact squared EDT by the full min-plus sweep over all columns."""
    if g2 is None:
        g2 = _pass1_g2(seeds)
    return _pass2(g2, g2.shape[0])


def squared_edt(seeds: torch.Tensor | None, g2: torch.Tensor | None = None,
                band_mask: torch.Tensor | None = None,
                big: float | None = None) -> torch.Tensor:
    """Exact squared EDT by the BANDED min-plus sweep (see the JAX
    ``squared_edt`` for the exactness argument): an upper bound U from
    sparse true candidates sizes a band of ``ceil(sqrt(max U)/128)+1``
    128-column chunks (the kernel's ``BAND_COLS``); past half the width
    the full sweep runs instead. With ``band_mask`` the band is sized
    over the masked pixels only (exact there, an overestimate elsewhere,
    as in JAX).

    ``big`` is the sentinel, ``(H + W)^2`` of ``g2`` by default. A
    row-sharded caller sweeping a block of the frame's rows passes the
    frame's ``(H + W)^2``: its pass-1 field holds the frame's sentinel,
    which the block's own can be smaller than."""
    if g2 is None:
        if seeds is None:
            raise ValueError("squared_edt needs seeds or g2")
        g2 = _pass1_g2(seeds)
    h, w = g2.shape
    if big is None:
        big = float((h + w) * (h + w))

    chunk = BAND_COLS
    n_chunks = -(-w // chunk)
    wp = n_chunks * chunk
    g2p = torch.nn.functional.pad(g2, (0, wp - w), value=big)
    upper = g2p
    for delta in (1, 4, 16, 64, 256, 1024):
        if delta >= w:
            break
        d2 = float(delta * delta)
        upper = torch.minimum(upper, shift_cols(g2p, delta, big) + d2)
        upper = torch.minimum(upper, shift_cols(g2p, -delta, big) + d2)
    upper = upper[:, :w]
    if band_mask is not None:
        upper = torch.where(band_mask.to(torch.bool), upper,
                            torch.zeros_like(upper))
    b_max = exact_sqrt(upper.max())
    max_off = torch.clamp((b_max / chunk).to(torch.int32) + 1,
                          max=n_chunks - 1)
    max_off = host_read(max_off)
    if 2 * max_off + 1 < n_chunks:
        band = torch.full((-(-h // BAND_ROWS), n_chunks), max_off,
                          dtype=torch.int32, device=g2.device)
        return minplus_pass2(g2.contiguous(), g2_max=int(big), band=band)
    return minplus_pass2(g2.contiguous(), g2_max=int(big))


def edt(seeds: torch.Tensor) -> torch.Tensor:
    """Exact L2 distance to the nearest True seed. (H, W) float32."""
    return exact_sqrt(squared_edt(seeds))


def edt_batch(seeds: torch.Tensor) -> torch.Tensor:
    """Exact L2 EDT of (C, H, W) or (H, W) seed masks, the counterpart of
    the JAX package's ``ops.edt.edt_batch`` and of its Pallas drop-in
    ``ops.pallas_edt.edt_batch_rowband``: pass 1 scans HORIZONTALLY
    (per-row distances), pass 2 is the min-plus along rows through the
    row-banded kernel (kernels/rowband.py). The result is exact (integer
    squared distances, one correctly rounded root), so it does not depend
    on which sweep computes it; every channel goes through the kernel in
    one launch, whose per-tile band adapts to each channel on the device
    with no host read."""
    seeds = seeds.to(torch.bool)
    squeeze = seeds.dim() == 2
    if squeeze:
        seeds = seeds[None]
    g = nearest_seed_dist_1d(seeds, axis=2).to(torch.float32)
    d = exact_sqrt(squared_edt_rowband((g * g).contiguous()))
    return d[0] if squeeze else d


edt_batch_rowband = edt_batch    # the JAX package's name for this route


def signed_edt(mask: torch.Tensor) -> torch.Tensor:
    """Signed distance field: positive inside ``mask``, negative outside
    (the reference's ``dist_inside - dist_outside`` construction)."""
    mask = mask.to(torch.bool)
    dist_inside = edt(~mask)     # distance to the nearest 0-pixel
    dist_outside = edt(mask)     # distance to the nearest 1-pixel
    return torch.where(mask, dist_inside, -dist_outside)


def _sample_cols(w: int, stride: int, device) -> torch.Tensor:
    """Every ``stride``-th column plus the last, int32 ascending."""
    js = torch.arange(0, w, stride, dtype=torch.int32, device=device)
    if (w - 1) % stride:
        js = torch.cat([js, torch.full((1,), w - 1, dtype=torch.int32,
                                       device=device)])
    return js


def _tile_candidates(ds: torch.Tensor, k: int, tile: int = 8):
    """Near-max samples of ``ds`` (H, ws) through a tile-max hierarchy
    (see the JAX ``_tile_candidates``). Returns (kth_bound, flat int64
    candidate sample indices, exhaustive). Tiles rank by a stable
    descending sort, so ties keep ascending index as ``lax.top_k``."""
    hh, ws = ds.shape
    t = max(1, -(-k // (tile * tile)))
    nr, ncs = -(-hh // tile), -(-ws // tile)
    exhaustive = t >= nr * ncs
    t = min(t, nr * ncs)
    dp = torch.nn.functional.pad(ds, (0, ncs * tile - ws, 0, nr * tile - hh),
                                 value=-1.0)
    tmax = dp.reshape(nr, tile, ncs, tile).amax(dim=(1, 3)).reshape(-1)
    tvals, tidx = torch.sort(tmax, descending=True, stable=True)
    tvals, tidx = tvals[:t], tidx[:t]
    tr, tc = tidx // ncs, tidx % ncs
    dd = torch.arange(tile, device=ds.device)
    rows = torch.clamp(tr[:, None] * tile + dd[None, :], 0, hh - 1)
    cidx = torch.clamp(tc[:, None] * tile + dd[None, :], 0, ws - 1)
    flat = (rows[:, :, None] * ws + cidx[:, None, :]).reshape(-1)
    return tvals[t - 1], flat, exhaustive


def _refine(g2: torch.Tensor, flat: torch.Tensor, js: torch.Tensor,
            slack: int, h: int):
    """Exact max/argmax of the EDT over the +-slack column windows of the
    candidate samples ``flat`` (flat index into (rows, len(js)))."""
    w = g2.shape[-1]
    ws = js.shape[0]
    rows = flat // ws
    scols = js[flat % ws].to(torch.int64)
    win = torch.arange(-slack, slack + 1, device=g2.device)
    jwin = torch.clamp(scols[:, None] + win[None, :], 0, w - 1)
    d2r = _pass2(g2[rows], h, qcol=jwin.to(torch.int32))
    dr = exact_sqrt(d2r)
    mx = dr.max()
    flat_pix = rows[:, None] * w + jwin
    amax = torch.where(dr == mx, flat_pix,
                       torch.full_like(flat_pix, h * w)).min()
    return mx, amax.to(torch.int32)


def _full_max_argmax(g2: torch.Tensor):
    d = exact_sqrt(_pass2(g2, g2.shape[0]))
    return d.max(), torch.argmax(d).to(torch.int32)


def edt_max_argmax(seeds: torch.Tensor, g2: torch.Tensor | None = None,
                   stride: int = 16, k: int = 1024):
    """Exact ``(max, argmax)`` of ``edt(seeds)`` without the pass-2 field:
    the exact envelope at every ``stride``-th column, a tile-max candidate
    set, exact refinement of the +-stride/2 windows around it, and the
    full sweep when coverage cannot be proven (see the JAX version for
    the argument). Returns (max f32, flat argmax int32)."""
    seeds = seeds.to(torch.bool)
    h, w = seeds.shape
    if g2 is None:
        g2 = _pass1_g2(seeds)
    js = _sample_cols(w, stride, g2.device)
    slack = stride // 2
    ds = exact_sqrt(_pass2(g2, h, qcol=js))
    m_low = ds.max()
    kth_bound, flat, exhaustive = _tile_candidates(ds, k)
    covered = True
    if not exhaustive:
        covered = host_read((kth_bound < m_low - (slack + 0.01))
                            | ~seeds.any() | seeds.all())
    if covered:
        return _refine(g2, flat, js, slack, h)
    return _full_max_argmax(g2)


def squared_edt_window(g2: torch.Tensor, r0: int, c0: int, hq: int,
                       wq: int) -> torch.Tensor:
    """Exact squared EDT on the query window rows [r0, r0+hq) x cols
    [c0, c0+wq) only; sources span the full frame. g2 is (H, W) or a
    (C, H, W) stack sharing the window; r0/c0 are host ints already
    clipped to the frame."""
    squeeze = g2.dim() == 2
    if squeeze:
        g2 = g2[None]
    c, h, w = g2.shape
    hq, wq = min(hq, h), min(wq, w)
    g2r = g2[:, r0:r0 + hq, :].reshape(c * hq, w)
    qcol = torch.arange(c0, c0 + wq, dtype=torch.int32, device=g2.device)
    d2 = _pass2(g2r, h, qcol=qcol).reshape(c, hq, wq)
    return d2[0] if squeeze else d2


def squared_edt_window_src(g2: torch.Tensor, r0: int, c0: int, hq: int,
                           wq: int, src_pad: int) -> torch.Tensor:
    """``squared_edt_window`` with sources restricted to the columns
    [c0 - src_pad, c0 + wq + src_pad) (clipped); exact iff every query
    pixel's distance is < ``src_pad``."""
    squeeze = g2.dim() == 2
    if squeeze:
        g2 = g2[None]
    c, h, w = g2.shape
    hq, wq = min(hq, h), min(wq, w)
    sw = min(wq + 2 * src_pad, w)
    s0 = min(max(c0 - src_pad, 0), w - sw)
    g2r = g2[:, r0:r0 + hq, :].reshape(c * hq, w)
    qcol = torch.arange(c0, c0 + wq, dtype=torch.int32, device=g2.device)
    d2 = _pass2(g2r, h, qcol=qcol, s_lo=s0, s_hi=s0 + sw)
    d2 = d2.reshape(c, hq, wq)
    return d2[0] if squeeze else d2


def edt_max_argmax_batch(g2: torch.Tensor, stride: int = 16, k: int = 1024,
                         constant_field: torch.Tensor | None = None):
    """Per-channel exact ``(max, argmax)`` of the EDTs whose pass-1
    squared fields are ``g2`` (C, H, W): one shared envelope launch, one
    host read of every channel's coverage guard, one refinement launch
    for the covered channels, a full sweep for the others."""
    c, h, w = g2.shape
    g2 = g2.to(torch.float32).contiguous()
    big = float((h + w) * (h + w))
    js = _sample_cols(w, stride, g2.device)
    ws = js.shape[0]
    slack = stride // 2
    ds = exact_sqrt(_pass2(g2.reshape(c * h, w), h, qcol=js)) \
        .reshape(c, h, ws)

    cands, guards = [], []
    for ci in range(c):
        m_low = ds[ci].max()
        kth_bound, flat, exhaustive = _tile_candidates(ds[ci], k)
        cands.append(flat)
        if exhaustive:
            guards.append(torch.ones((), dtype=torch.bool, device=g2.device))
            continue
        g2c = g2[ci]
        covered = (kth_bound < m_low - (slack + 0.01)) \
            | ~(g2c < big).any() | ~(g2c > 0).any()
        if constant_field is not None:
            covered = covered | constant_field[ci]
        guards.append(covered)
    covered = host_read(torch.stack(guards))

    maxes, argmaxes = [None] * c, [None] * c
    ok = [ci for ci in range(c) if covered[ci]]
    if ok:
        flat = torch.cat([cands[ci] + ci * h * ws for ci in ok])
        rows_all = g2.reshape(c * h, w)
        w_all = torch.arange(-slack, slack + 1, device=g2.device)
        rows = flat // ws
        scols = js[flat % ws].to(torch.int64)
        jwin = torch.clamp(scols[:, None] + w_all[None, :], 0, w - 1)
        dr = exact_sqrt(_pass2(rows_all[rows], h,
                               qcol=jwin.to(torch.int32)))
        sizes = [cands[ci].shape[0] for ci in ok]
        for ci, dr_c, rows_c, jwin_c in zip(ok, dr.split(sizes),
                                            rows.split(sizes),
                                            jwin.split(sizes)):
            mx = dr_c.max()
            flat_pix = (rows_c - ci * h)[:, None] * w + jwin_c
            amax = torch.where(dr_c == mx, flat_pix,
                               torch.full_like(flat_pix, h * w)).min()
            maxes[ci], argmaxes[ci] = mx, amax.to(torch.int32)
    for ci in range(c):
        if not covered[ci]:
            maxes[ci], argmaxes[ci] = _full_max_argmax(g2[ci])
    return torch.stack(maxes), torch.stack(argmaxes)
