# Frozen copy of leafgrasp_tpu_torch/kernels/minplus.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
# The kernel wrapper always takes its plain PyTorch version.
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

The contract on values, on the card: ``g2`` holds f32 values, ``+inf``
marking a column that is no source. The kernel runs in one of two forms,
which ``minplus_form`` picks from ``W`` and the largest finite value the
caller states (``g2_max``), with no host read:

* expanded, where ``g2_max <= 2^24 - 2 W^2`` (``max_g2(W)``, integer
  values): the square is expanded into ``(g2 + s^2) - 2 q s + q^2``, one
  fused multiply-add a source, and every intermediate is an integer below
  2^24 in magnitude, so nothing rounds;
* direct, everywhere else and wherever no bound is stated:
  ``(q - s)^2`` rounded to f32, then ``g2 + (q - s)^2`` rounded once.

The direct form is the JAX package's own evaluation
(leafgrasp_tpu/ops/edt.py, ``off = (q - s)^2`` then ``g2 + off``), and
the plain version's: the square is exact while ``W <= 4097``
(``(W - 1)^2 <= 2^24``) and rounds alike on every device past that, and
the sum rounds once, the same way everywhere. Rounding is monotone, so
the minimum of the rounded candidates is the same too: kernel, plain
version and JAX agree bit for bit at every frame size and for any values,
past 2^24 included (a seedless frame's sentinel ``(H + W)^2``, say).
Within the expanded form's range both forms give the same result; the
expanded one keeps the production frames (1080 x 1440, 1080 x 1920)
where they were. ``ops/edt.py`` states each frame's sentinel as
``g2_max``.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels import LAUNCHES

__all__ = ["minplus_pass2", "minplus_pass2_plain", "BAND_ROWS",
           "BAND_COLS", "max_g2", "minplus_form"]

BAND_ROWS = 8      # row tile of a band entry (MP_ROWS in the kernel)
BAND_COLS = 128    # column chunk of a band entry (MP_CHUNK in the kernel)


def max_g2(w: int) -> int:
    """The largest finite ``g2`` value the kernel takes at width ``w``."""
    return (1 << 24) - 2 * w * w


def minplus_form(w: int, g2_max: int | None = None) -> str:
    """The form of the min-plus kernel at width ``w`` for finite values of
    at most ``g2_max``: ``"expanded"`` where that is exact (``g2_max <=
    max_g2(w)``), else ``"direct"``, which rounds as the plain version
    and the JAX package do for any values; without ``g2_max``, direct."""
    if g2_max is not None and g2_max <= max_g2(w):
        return "expanded"
    return "direct"


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
    tensor at 1080 x 1440 would be 8.9 GB). It rounds ``(q - s)^2``, then
    ``g2 + (q - s)^2``, as the JAX package does."""
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
    version for a CPU tensor. ``g2_max``, the largest finite value of
    ``g2`` where the caller knows it, lets ``minplus_form`` pick the
    expanded form; either form gives the plain version's result."""
    if g2.device.type in ("cpu", "cuda"):
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
