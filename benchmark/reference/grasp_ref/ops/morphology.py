# Frozen copy of leafgrasp_tpu_torch/ops/morphology.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Binary morphology with OpenCV-parity structuring elements, PyTorch
port of leafgrasp_tpu/ops/morphology.py.

Every OpenCV ellipse row is a contiguous run around the anchor, so a
dilation is k shifted compares of the along-row nearest-seed distance
(one ``cummax``/``cummin`` pair) instead of a k x k correlation; the
vertical distances of a dilated mask (``dilated_vertical_dist_multi``)
come straight from the undilated mask's directional distances, by
either the sparse-table "levels" erosion or the per-offset "runs" loop,
bit-identical in int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.grasp_ref.ops.edt import directional_seed_dist_1d, shift_cols

__all__ = ["elliptical_kernel", "rect_kernel", "dilate", "erode",
           "morphological_boundary", "dilated_vertical_dist",
           "dilated_vertical_dist_multi"]


@functools.lru_cache(maxsize=64)
def elliptical_kernel(width: int, height: int | None = None) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (w, h))`` bit for
    bit (OpenCV's rasterization: row dy spans c +- round-half-away(
    c * sqrt((r*r - dy*dy) / (r*r))))."""
    if height is None:
        height = width
    r = height // 2
    c = width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    kernel = np.zeros((height, width), dtype=np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(np.floor(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2) + 0.5))
        kernel[i, max(c - dx, 0):min(c + dx + 1, width)] = 1
    return kernel


def rect_kernel(width: int, height: int | None = None) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_RECT, (w, h))``."""
    if height is None:
        height = width
    return np.ones((height, width), dtype=np.uint8)


def _row_runs(kernel: np.ndarray):
    """Per-row runs of the SE as (dy_src, reach_left, reach_right)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for i in range(kh):
        cols = np.flatnonzero(kernel[i])
        if cols.size == 0:
            continue
        if not np.array_equal(cols, np.arange(cols[0], cols[-1] + 1)):
            raise ValueError("structuring element rows must be contiguous")
        lo, hi = int(cols[0] - ax), int(cols[-1] - ax)
        if lo > 0 or hi < 0:
            raise ValueError("SE row must straddle the anchor column")
        runs.append((i - ay, -lo, hi))
    return runs


def _shift_rows(arr: torch.Tensor, dy: int, fill) -> torch.Tensor:
    """out[y] = arr[y + dy], ``fill`` rows where y + dy is out of bounds."""
    if dy == 0:
        return arr
    pad = torch.full((abs(dy), arr.shape[1]), fill, dtype=arr.dtype,
                     device=arr.device)
    if dy > 0:
        return torch.cat([arr[dy:], pad], dim=0)
    return torch.cat([pad, arr[:dy]], dim=0)


def dilate(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Binary dilation; bool (H, W). Out-of-bounds pixels are background."""
    m = mask.to(torch.bool)
    h, w = m.shape
    d_left, d_right = directional_seed_dist_1d(m, axis=1)
    big = h + w
    out = torch.zeros((h, w), dtype=torch.bool, device=m.device)
    for dy_src, reach_left, reach_right in _row_runs(np.asarray(kernel)):
        dl = _shift_rows(d_left, dy_src, big)
        dr = _shift_rows(d_right, dy_src, big)
        out = out | (dl <= reach_left) | (dr <= reach_right)
    return out


def erode(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Binary erosion with OpenCV border semantics (OOB = foreground)."""
    return ~dilate(~mask.to(torch.bool), kernel)


def morphological_boundary(mask: torch.Tensor,
                           kernel: np.ndarray | None = None) -> torch.Tensor:
    """mask minus its erosion: the reference's tip/contour band
    (grasp_point_selector.py:705-708)."""
    if kernel is None:
        kernel = elliptical_kernel(3, 3)
    m = mask.to(torch.bool)
    return m & ~erode(m, kernel)


def _col_runs(kernel: np.ndarray):
    """Per-column vertical runs of the SE as (dx, up_reach, dn_reach)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for j in range(kw):
        rows = np.flatnonzero(kernel[:, j])
        if rows.size == 0:
            continue
        if not np.array_equal(rows, np.arange(rows[0], rows[-1] + 1)):
            raise ValueError("SE columns must be contiguous")
        up, dn = ay - int(rows[0]), int(rows[-1]) - ay
        if up < 0 or dn < 0:
            raise ValueError("SE column must straddle the anchor row")
        runs.append((j - ax, up, dn))
    return runs


def dilated_vertical_dist(d_up: torch.Tensor, d_dn: torch.Tensor,
                          kernel: np.ndarray) -> torch.Tensor:
    """``dilated_vertical_dist_multi`` for one SE: the vertical
    nearest-seed distances of ``dilate(mask, kernel)`` (int32 (H, W),
    the no-seed sentinel H + W) without materializing the dilation."""
    return dilated_vertical_dist_multi(d_up, d_dn, (kernel,))[0]


def dilated_vertical_dist_multi(d_up: torch.Tensor, d_dn: torch.Tensor,
                                kernels, impl: str = "levels") -> list:
    """Vertical nearest-seed distances of ``dilate(mask, k)`` for each SE
    ``k``, from the undilated mask's directional distances ``d_up`` /
    ``d_dn`` (see the JAX ``dilated_vertical_dist``), by the sparse-table
    ``"levels"`` erosion or the per-offset ``"runs"`` loop
    (bit-identical int32). ``"levels"`` needs unimodal column heights and
    a non-empty SE; otherwise ``"runs"`` serves."""
    if impl not in ("levels", "runs"):
        raise ValueError(f"unknown dilated_vertical_dist impl {impl!r}")
    runs_per_k = [_col_runs(np.asarray(k)) for k in kernels]
    d_up = d_up.to(torch.int32)
    d_dn = d_dn.to(torch.int32)
    big = d_up.shape[0] + d_up.shape[1]
    if impl == "levels":
        lv = [(_se_levels(runs, 1), _se_levels(runs, 2))
              for runs in runs_per_k]
        if all(a is not None and b is not None for a, b in lv):
            return _dvd_levels(d_up, d_dn, lv, big)
    return _dvd_runs(d_up, d_dn, runs_per_k, big)


def _dvd_runs(d_up, d_dn, runs_per_k, big) -> list:
    by_dx: dict = {}
    for ki, runs in enumerate(runs_per_k):
        for dx, up, dn in runs:
            by_dx.setdefault(dx, []).append((ki, up, dn))
    outs = [torch.full_like(d_up, big) for _ in runs_per_k]
    for dx in sorted(by_dx):
        du = shift_cols(d_up, dx, big)
        dd = shift_cols(d_dn, dx, big)
        for ki, up, dn in by_dx[dx]:
            cand = torch.minimum(torch.clamp(du - up, min=0),
                                 torch.clamp(dd - dn, min=0))
            outs[ki] = torch.minimum(outs[ki], cand)
    return outs


def _se_levels(runs, which):
    """(value, lo, hi) windows {dx : s(dx) >= v} per distinct height v
    of one direction's structuring function; None when a window is not
    contiguous or the SE is empty (the caller then uses "runs")."""
    if not runs:
        return None
    dxs = np.array([r[0] for r in runs])
    vals = np.array([r[which] for r in runs])
    order = np.argsort(dxs)
    dxs, vals = dxs[order], vals[order]
    if not np.array_equal(dxs, np.arange(dxs[0], dxs[-1] + 1)):
        return None
    levels = []
    for v in np.unique(vals):
        sel = np.flatnonzero(vals >= v)
        if not np.array_equal(sel, np.arange(sel[0], sel[-1] + 1)):
            return None
        levels.append((int(v), int(dxs[sel[0]]), int(dxs[sel[-1]])))
    return levels


def _dvd_levels(d_up, d_dn, levels_per_k, big) -> list:
    windows = [wnd for lv_up, lv_dn in levels_per_k
               for wnd in lv_up + lv_dn]
    max_len = max(hi - lo + 1 for v, lo, hi in windows)
    pmax = max_len.bit_length() - 1
    # pad lmax sentinel columns on the left so negative-start window
    # reads stay in range (see the JAX ``_dvd_levels``), crop after
    lmax = max(0, max(-lo for v, lo, hi in windows))
    h, w = d_up.shape

    def tables(d):
        # t[p][:, x] = min over s in [0, 2^p) of d[:, x + s] (OOB = big)
        if lmax:
            d = torch.cat([torch.full((h, lmax), big, dtype=d.dtype,
                                      device=d.device), d], dim=1)
        t = [d]
        for p in range(1, pmax + 1):
            t.append(torch.minimum(t[-1],
                                   shift_cols(t[-1], 1 << (p - 1), big)))
        return t

    t_up, t_dn = tables(d_up), tables(d_dn)

    def erosion(tabs, levels):
        out = None
        for v, lo, hi in levels:
            p = (hi - lo + 1).bit_length() - 1
            wmin = torch.minimum(
                shift_cols(tabs[p], lmax + lo, big),
                shift_cols(tabs[p], lmax + hi - (1 << p) + 1, big))
            cand = wmin - v
            out = cand if out is None else torch.minimum(out, cand)
        return out[:, :w] if lmax else out

    return [torch.minimum(torch.clamp(erosion(t_up, lv_up), min=0),
                          torch.clamp(erosion(t_dn, lv_dn), min=0))
            for lv_up, lv_dn in levels_per_k]
