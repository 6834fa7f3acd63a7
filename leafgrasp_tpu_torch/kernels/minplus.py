"""EDT pass-2 min-plus: the kernel wrapper and its plain version.

    out[r, q] = min over s in [s_lo, s_hi) of g2[r, s] + (qcol[q] - s)^2

for f32 ``g2`` (R, W). ``qcol`` holds the query columns: ``None`` for
all W columns, a (nq,) int32 vector shared by every row (a window
``c0..c0+wq`` or the envelope's sampled columns), or an (R, nq) matrix
with one set per row (the envelope refinement windows). ``band``, an
int32 (ceil(R/8), ceil(W/128)) tensor of radii in 128-column chunks,
restricts row tile i, query chunk t to the source chunks [t-nb, t+nb]
(the banded sweep; needs ``qcol=None``).

Replaces the TPU kernels ``squared_edt_pass2`` and
``squared_edt_pass2_banded`` (leafgrasp_tpu/ops/pallas_edt.py:65, :119)
and every XLA min-plus of leafgrasp_tpu/ops/edt.py; the kernel source,
with its bound and design, is ``csrc/minplus.cu``.

The contract on values, on the card: ``g2`` is integer-valued and
``+inf`` marks a column that is no source. The kernel runs in one of two
forms, which ``minplus_form`` picks from ``W`` and the largest finite
value the caller states (``g2_max``), with no host read:

* expanded, where ``g2_max <= 2^24 - 2 W^2`` (``max_g2(W)``): the square
  is expanded into ``(g2 + s^2) - 2 q s + q^2``, one fused multiply-add a
  source, and every intermediate is an integer below 2^24 in magnitude;
* direct, where ``g2_max + W^2 <= 2^24``: ``fmaf(q - s, q - s, g2)``, an
  integer of at most 2^24 rounded once;
* otherwise it raises, where the plain version would not be exact
  either.

A call without ``g2_max`` keeps the expanded form's contract, finite
values at most ``max_g2(W)``, and raises from the shape alone where that
leaves no room for the sentinel of a frame as wide as it is tall,
``(2 W)^2`` (``W > MAX_WIDTH``). Either way kernel and plain version
agree bit for bit. The plain version computes the direct form
``g2 + (q - s)^2``, exact while that sum stays at most 2^24.
``check_frame`` holds a frame's shape to the same range on both devices;
``ops/edt.py`` calls it before every min-plus and states the frame's
sentinel as ``g2_max``.
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["minplus_pass2", "minplus_pass2_plain", "BAND_ROWS",
           "BAND_COLS", "max_g2", "MAX_WIDTH", "check_frame",
           "minplus_form"]

BAND_ROWS = 8      # row tile of a band entry (MP_ROWS in the kernel)
BAND_COLS = 128    # column chunk of a band entry (MP_CHUNK in the kernel)
MAX_WIDTH = 1672   # the widest W with (2 W)^2 + 2 W^2 < 2^24


def max_g2(w: int) -> int:
    """The largest finite ``g2`` value the kernel takes at width ``w``."""
    return (1 << 24) - 2 * w * w


def minplus_form(w: int, g2_max: int | None = None) -> str:
    """The form of the min-plus kernel that is exact at width ``w`` for
    finite values of at most ``g2_max``: ``"expanded"`` or ``"direct"``.
    Without ``g2_max`` the caller keeps ``max_g2(w)`` and ``w`` must be at
    most ``MAX_WIDTH``. Raises where neither form is exact, which is where
    the plain version is not exact either."""
    if g2_max is None:
        if w > MAX_WIDTH:
            raise ValueError(f"W={w}: the sums of the min-plus kernel could "
                             f"pass 2^24 (the widest W without a stated "
                             f"bound is {MAX_WIDTH})")
        return "expanded"
    if g2_max <= max_g2(w):
        return "expanded"
    if g2_max + w * w <= 1 << 24:
        return "direct"
    raise ValueError(f"values up to {g2_max} at W={w}: g2 + (q - s)^2 could "
                     f"pass 2^24, the min-plus would not be exact")


def check_frame(h: int, w: int) -> None:
    """Raise where the min-plus over the pass-1 field of an ``h`` x ``w``
    frame, whose largest value is the sentinel ``(h + w)^2``, would not
    be exact: ``(H + W)^2 + W^2 <= 2^24``, on either device (the card
    picks its form by ``minplus_form``, which covers that range whole)."""
    minplus_form(w, (h + w) ** 2)

# elements of the (R, S, nq) candidate block the plain version builds
_PLAIN_BLOCK = 1 << 25


def _check_args(g2, qcol, s_lo, s_hi, band):
    if g2.dtype != torch.float32 or g2.dim() != 2:
        raise ValueError(f"g2 must be 2-D float32, got {g2.dtype} "
                         f"{tuple(g2.shape)}")
    r, w = g2.shape
    s_hi = w if s_hi is None else int(s_hi)
    if not 0 <= s_lo < s_hi <= w:
        raise ValueError(f"bad source range [{s_lo}, {s_hi}) for W={w}")
    if qcol is not None:
        if qcol.dtype != torch.int32 or qcol.dim() not in (1, 2):
            raise ValueError("qcol must be int32 (nq,) or (R, nq)")
        if qcol.dim() == 2 and qcol.shape[0] != r:
            raise ValueError("per-row qcol needs one row per g2 row")
        if qcol.device != g2.device:
            raise ValueError("qcol and g2 on different devices")
    if band is not None:
        if qcol is not None:
            raise ValueError("band needs qcol=None (all columns)")
        want = (-(-r // BAND_ROWS), -(-w // BAND_COLS))
        if band.dtype != torch.int32 or tuple(band.shape) != want:
            raise ValueError(f"band must be int32 {want}")
        if band.device != g2.device:
            raise ValueError("band and g2 on different devices")
    return s_hi


def minplus_pass2_plain(g2: torch.Tensor, qcol: torch.Tensor | None = None,
                        s_lo: int = 0, s_hi: int | None = None,
                        band: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version, chunked over source columns so the
    (R, S, nq) candidate block stays bounded (the unchunked (H, W, W)
    tensor at 1080 x 1440 would be 8.9 GB)."""
    s_hi = _check_args(g2, qcol, s_lo, s_hi, band)
    r, w = g2.shape
    dev = g2.device
    if qcol is None:
        qcol = torch.arange(w, dtype=torch.int32, device=dev)
    per_row = qcol.dim() == 2
    nq = qcol.shape[-1]
    qf = qcol.to(torch.float32)
    qf = qf[:, None, :] if per_row else qf[None, None, :]     # (R|1,1,nq)
    if band is not None:
        rt = torch.arange(r, device=dev) // BAND_ROWS
        qt = torch.arange(nq, device=dev) // BAND_COLS
        nb = band[rt[:, None], qt[None, :]]                   # (R, nq)
        lo = ((qt[None, :] - nb) * BAND_COLS)[:, None, :]
        hi = ((qt[None, :] + nb + 1) * BAND_COLS)[:, None, :]
    out = torch.full((r, nq), float("inf"), dtype=torch.float32,
                     device=dev)
    step = max(1, _PLAIN_BLOCK // max(1, r * nq))
    for s0 in range(s_lo, s_hi, step):
        s1 = min(s_hi, s0 + step)
        s_idx = torch.arange(s0, s1, device=dev)
        d = qf - s_idx.to(torch.float32)[None, :, None]       # (., S, nq)
        cand = g2[:, s0:s1, None] + d * d                     # (R, S, nq)
        if band is not None:
            s3 = s_idx[None, :, None]
            cand = torch.where((s3 >= lo) & (s3 < hi), cand,
                               torch.full_like(cand, float("inf")))
        out = torch.minimum(out, cand.amin(dim=1))
    return out


def minplus_pass2(g2: torch.Tensor, qcol: torch.Tensor | None = None,
                  s_lo: int = 0, s_hi: int | None = None,
                  band: torch.Tensor | None = None,
                  g2_max: int | None = None) -> torch.Tensor:
    """The min-plus above: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. On the card ``g2`` keeps the module's
    contract: integers, finite values at most ``g2_max`` where the caller
    states it, else at most ``max_g2(W)`` with ``W <= MAX_WIDTH``; the form
    follows from ``minplus_form``, which raises outside the exact range."""
    if g2.device.type == "cpu":
        return minplus_pass2_plain(g2, qcol, s_lo, s_hi, band)
    if g2.device.type != "cuda":
        raise ValueError(f"unsupported device {g2.device}")
    s_hi = _check_args(g2, qcol, s_lo, s_hi, band)
    g2 = g2.contiguous()
    r, w = g2.shape
    direct = minplus_form(w, g2_max) == "direct"
    if qcol is None:
        qcol = torch.arange(w, dtype=torch.int32, device=g2.device)
    qcol = qcol.contiguous()
    nq = qcol.shape[-1]
    out = torch.empty((r, nq), dtype=torch.float32, device=g2.device)
    band_ptr, n_band_cols = None, 0
    if band is not None:
        band = band.contiguous()
        band_ptr, n_band_cols = band.data_ptr(), band.shape[1]
    lib = load_library()
    err = lib.minplus_pass2(
        g2.data_ptr(), r, w, qcol.data_ptr(), nq, int(qcol.dim() == 2),
        int(s_lo), s_hi, band_ptr, n_band_cols, int(direct), out.data_ptr(),
        torch.cuda.current_stream(g2.device).cuda_stream)
    check(err, "minplus_pass2")
    LAUNCHES["minplus_pass2"] += 1
    return out
