"""Standalone SDF utilities, PyTorch port of
leafgrasp_tpu/geometry/sdf_helper.py (rebuild of
scripts/utils/sdf_helper.py).

The reference keeps these as a separate helper class whose logic partly
duplicates the leaf scorer (SURVEY.md 2.3); they are preserved here as
plain functions because downstream robot code may call them directly:
global SDF of the leaf union, per-leaf SDF, the approach vector (Sobel
gradient of the leaf SDF at the grasp point, sdf_helper.py:49-76), and
the isolation metric mean(leaf SDF)/max(global SDF)
(sdf_helper.py:78-100).
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.ops.conv import sobel_gradients
from leafgrasp_tpu_torch.ops.edt import edt, signed_edt

__all__ = ["global_sdf", "leaf_sdf", "approach_vector", "isolation_metric"]


def global_sdf(all_mask: torch.Tensor) -> torch.Tensor:
    """Distance field of the background w.r.t. every leaf: 0 on leaves
    (skfmm.distance on the inverted union, sdf_helper.py:13-36)."""
    return edt(all_mask.to(torch.bool))


def leaf_sdf(leaf_mask: torch.Tensor) -> torch.Tensor:
    """Signed per-leaf field: positive inside (sdf_helper.py:38-47 uses
    skfmm.distance(~mask) which is distance-to-leaf outside; the signed
    variant carries both sides and matches the gradient use below)."""
    return signed_edt(leaf_mask)


def approach_vector(leaf_mask: torch.Tensor, grasp_uv) -> torch.Tensor:
    """Normalized 2D approach direction = Sobel gradient of the leaf SDF
    at the grasp pixel (sdf_helper.py:49-76)."""
    sdf = leaf_sdf(leaf_mask)
    gx, gy = sobel_gradients(sdf)
    u, v = int(grasp_uv[0]), int(grasp_uv[1])
    g = torch.stack([gx[v, u], gy[v, u]])
    n = torch.sqrt((g * g).sum())
    default = torch.tensor([0.0, -1.0], dtype=g.dtype, device=g.device)
    return torch.where(n > 1e-8, g / torch.clamp(n, min=1e-8), default)


def isolation_metric(leaf_mask: torch.Tensor,
                     all_mask: torch.Tensor) -> torch.Tensor:
    """mean(leaf interior distance) / max(global SDF)
    (sdf_helper.py:78-100)."""
    m = leaf_mask.to(torch.bool)
    interior = edt(~m)
    gsdf = global_sdf(all_mask)
    mean_leaf = (interior * m).sum() / torch.clamp(
        m.sum().to(torch.float32), min=1.0)
    return mean_leaf / torch.clamp(gsdf.max(), min=1e-6)
