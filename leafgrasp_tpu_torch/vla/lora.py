"""LoRA adapters on linear layers: the forward half of
leafgrasp_tpu/vla/lora.py.

    y = x W^T + (alpha / r) * ((x A) B),   A (in, r),   B (r, out)

``LoRADense`` nests its frozen weight under ``base`` (``base.weight``,
as the JAX module nests ``base/kernel``) and keeps ``lora_a`` /
``lora_b`` in the JAX orientation, so an adapter file maps leaf by leaf.
Like the JAX module it ignores any compute type: it works in the
promoted type of its input and its parameters. The adapter mask, the
extraction and grafting helpers and dropout in training mode belong to
the trainer and are not here yet.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["LoRADense", "merge_lora_params"]


def linear_promoted(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in the promoted type of its operands (a
    layer without a compute type in the JAX package)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


class LoRADense(nn.Module):
    """Linear layer with an optional rank-``rank`` adapter (0: none)."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 32.0, dropout: float = 0.0,
                 use_bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.dropout = float(dropout)      # applies in training only
        self.base = nn.Linear(in_features, features, bias=use_bias,
                              device=device, dtype=dtype)
        if self.rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(
                (in_features, self.rank), device=device, dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros(
                (self.rank, features), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rank > 0 and self.dropout > 0:
            raise NotImplementedError(
                "LoRA dropout in training mode comes with the trainer's "
                "port; call .eval() to serve")
        y = linear_promoted(x, self.base.weight, self.base.bias)
        if self.rank > 0:
            dt = torch.promote_types(x.dtype, self.lora_a.dtype)
            delta = (x.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + (self.alpha / self.rank) * delta
        return y


def merge_lora_params(state: Dict[str, torch.Tensor],
                      adapter: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Overlay saved adapter leaves onto a ``state_dict``."""
    out = dict(state)
    out.update(adapter)
    return out
