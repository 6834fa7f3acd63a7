"""LoRA adapters on linear layers: the port of leafgrasp_tpu/vla/lora.py.

    y = x W^T + (alpha / r) * ((dropout(x) A) B),   A (in, r),   B (r, out)

``LoRADense`` nests its frozen weight under ``base`` (``base.weight``,
as the JAX module nests ``base/kernel``) and keeps ``lora_a`` /
``lora_b`` in the JAX orientation, so an adapter file maps leaf by leaf.
Like the JAX module it ignores any compute type: it works in the
promoted type of its input and its parameters.

Dropout follows Flax's ``nn.Dropout``: in training mode, and only on the
adapter's input (never the base path), each element is kept with
probability ``1 - p`` and scaled by ``1 / (1 - p)``. The masks come from
the ``torch.Generator`` that the trainer hands each module
(``set_dropout_generator``). ``dropout_in_training=False`` turns it off
in training mode too: ``LlavaTorch`` builds its adapters so, because the
JAX ``LlavaJax`` never passes ``train`` to its ``LoRADense`` layers.

The helpers work on ``state_dict``s (flat ``"a.b.c"`` keys):
``lora_mask`` marks the adapter leaves, ``extract_lora_params`` keeps
them, ``graft_base_params`` carries an adapter-free state into the frozen
slots of a LoRA state, ``merge_lora_params`` overlays saved adapters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["LoRADense", "lora_mask", "merge_lora_params",
           "graft_base_params", "extract_lora_params",
           "set_dropout_generator", "is_lora_key"]

LORA_LEAVES = ("lora_a", "lora_b")


def linear_promoted(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in the promoted type of its operands (a
    layer without a compute type in the JAX package)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


class PromotedLinear(nn.Linear):
    """A linear layer without a compute type (``linear_promoted``): the
    language models' unquantized ``lm_head``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_promoted(x, self.weight, self.bias)


class LoRADense(nn.Module):
    """Linear layer with an optional rank-``rank`` adapter (0: none)."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 32.0, dropout: float = 0.0,
                 use_bias: bool = False, device=None,
                 dtype=torch.float32, dropout_in_training: bool = True,
                 base: Optional[nn.Module] = None):
        super().__init__()
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.dropout = float(dropout)      # applies in training only
        self.dropout_in_training = bool(dropout_in_training)
        self.generator: Optional[torch.Generator] = None
        # ``base``: a frozen layer other than a plain linear one (the
        # quantized base of ``QuantLoRADense``)
        self.base = base if base is not None else nn.Linear(
            in_features, features, bias=use_bias, device=device, dtype=dtype)
        if self.rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(
                (in_features, self.rank), device=device, dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros(
                (self.rank, features), device=device, dtype=dtype))

    def _dropped(self, x: torch.Tensor) -> torch.Tensor:
        """Flax's dropout of the adapter input: keep with 1 - p, scale."""
        if self.generator is None:
            raise RuntimeError(
                "LoRA dropout in training mode draws its masks from the "
                "trainer's torch.Generator: call set_dropout_generator "
                "first (or .eval() to serve)")
        keep_prob = 1.0 - self.dropout
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def base_forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_promoted(x, self.base.weight, self.base.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base_forward(x)
        if self.rank > 0:
            y = y + self.adapter_delta(x, self.lora_a)
        return y

    def adapter_delta(self, x: torch.Tensor,
                      lora_a: torch.Tensor) -> torch.Tensor:
        """(alpha / r) (dropout(x) A) B with the ``A`` given: the layer's
        own, or the tensor-parallel form's (parallel/sharding.py), whose
        gradient sums over the model axis."""
        h = x
        if self.training and self.dropout > 0 and self.dropout_in_training:
            h = self._dropped(x)
        dt = torch.promote_types(h.dtype, lora_a.dtype)
        delta = (h.to(dt) @ lora_a.to(dt)) @ self.lora_b.to(dt)
        return (self.alpha / self.rank) * delta


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand every ``LoRADense`` of ``model`` the generator its dropout
    masks come from (one stream, drawn in the order the layers run)."""
    for module in model.modules():
        if isinstance(module, LoRADense):
            module.generator = generator


def is_lora_key(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in LORA_LEAVES


def lora_mask(state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True for the adapter leaves (trainable), False for the frozen
    base: a ``state_dict``'s keys, as the JAX function's pytree."""
    return {k: is_lora_key(k) for k in state}


def extract_lora_params(state: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The adapter leaves of a ``state_dict`` (for an adapter save)."""
    return {k: v for k, v in state.items() if is_lora_key(k)}


def graft_base_params(lora_state: Mapping[str, torch.Tensor],
                      plain_state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Copy an adapter-free ``state_dict`` into the frozen-base slots of
    a LoRA-wrapped one (``LoRADense`` nests its weight under ``base``);
    the adapter leaves of ``lora_state`` are kept. The plain state may or
    may not nest under ``base`` (a rank-0 ``LoRADense`` does). Raises
    ``KeyError`` for a frozen slot the plain state lacks."""
    out = {}
    for k, v in lora_state.items():
        if is_lora_key(k):
            out[k] = v
            continue
        pk = k if k in plain_state else k.replace(".base.", ".")
        if pk not in plain_state:
            raise KeyError(f"pretrained state missing {pk}")
        out[k] = plain_state[pk]
    return out


def merge_lora_params(state: Mapping[str, torch.Tensor],
                      adapter: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Overlay saved adapter leaves onto a ``state_dict``."""
    out = dict(state)
    out.update(adapter)
    return out
