# Frozen copy of leafgrasp_tpu_torch/ops/topk.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Top-k candidate extraction with minimum-spacing suppression, PyTorch
port of leafgrasp_tpu/ops/topk.py.

k rounds of {argmax; suppress a Chebyshev ball of radius 2r} reproduce
the reference's greedy box suppression (grasp_point_selector.py:447-482).
Ties break by ascending flat index: ``torch.argmax`` returns the first
maximal index, as ``jnp.argmax`` does; ``torch.topk`` is never used, its
tie order being unspecified.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Candidates", "topk_min_distance"]


class Candidates(NamedTuple):
    x: torch.Tensor        # (k,) int32 column coordinates
    y: torch.Tensor        # (k,) int32 row coordinates
    score: torch.Tensor    # (k,) float32 score at the point
    accepted: torch.Tensor  # (k,) bool: False once the frame ran out


def topk_min_distance(score: torch.Tensor, valid: torch.Tensor,
                      k: int = 20, min_distance: int = 10) -> Candidates:
    """Greedy spaced top-k of ``score * valid`` (invalid pixels take part
    with score 0, grasp_point_selector.py:452). Runs on the device with
    no host reads."""
    h, w = score.shape
    dev = score.device
    s = torch.where(valid.to(torch.bool), score.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=dev))
    radius = 2 * min_distance
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    xs, ys, vals = [], [], []
    for _ in range(k):
        flat = s.reshape(-1)
        idx = torch.argmax(flat)
        y, x = idx // w, idx % w
        vals.append(flat[idx])
        suppress = ((rows - y).abs() <= radius) & ((cols - x).abs() <= radius)
        s = torch.where(suppress, neg, s)
        xs.append(x)
        ys.append(y)
    vals = torch.stack(vals)
    return Candidates(x=torch.stack(xs).to(torch.int32),
                      y=torch.stack(ys).to(torch.int32), score=vals,
                      accepted=torch.isfinite(vals))
