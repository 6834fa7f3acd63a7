# Frozen copy of leafgrasp_tpu_torch/ops/pareto.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Vectorized Pareto front (all-max sense), PyTorch port of
leafgrasp_tpu/ops/pareto.py (replaces ``paretoset``,
reference leaf_scorer.py:158-163)."""

from __future__ import annotations

import torch

__all__ = ["pareto_mask"]


def pareto_mask(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Non-dominated rows of ``scores`` (K, M) among ``valid`` (K,) rows;
    invalid rows are never on the front and never dominate."""
    valid = valid.to(torch.bool)
    ge = (scores[:, None, :] >= scores[None, :, :]).all(dim=-1)  # j >= i
    gt = (scores[:, None, :] > scores[None, :, :]).any(dim=-1)
    dominates = ge & gt & valid[:, None]                          # j dom i
    return valid & ~dominates.any(dim=0)
