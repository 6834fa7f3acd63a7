"""Weights drawn by the benchmark from ``--seed``, on the card, in the
type they are served in, in one large draw: the program and the plain
reference are each handed a copy of the same tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch


def _fan_in(name: str, shape) -> int:
    if name.endswith("kernel"):         # the gate's (in, out) kernels
        return int(shape[0])
    return int(math.prod(shape[1:]))


def draw_cnn_state(template: Dict[str, torch.Tensor], seed: int,
                   dev) -> Dict[str, torch.Tensor]:
    """A state for a model with ``template``'s names and shapes:
    weights N(0, 2 / fan-in), biases N(0, 0.05^2), BatchNorm gains
    1 + N(0, 0.1^2), shifts and running means N(0, 0.05^2), running
    variances exp(N(0, 0.2^2)); float32, from one draw of a
    ``torch.Generator`` on ``dev`` seeded with ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    items = [(k, v) for k, v in template.items() if v.is_floating_point()]
    total = sum(v.numel() for _, v in items)
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, off = {}, 0
    bn_prefixes = {k.rsplit(".", 1)[0] for k in template
                   if k.endswith("running_var")}
    for name, t in template.items():
        if not t.is_floating_point():
            out[name] = torch.zeros_like(t, device=dev)
            continue
        z = flat[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
        owner = name.rsplit(".", 1)[0]
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            val = torch.exp(0.2 * z)
        elif owner in bn_prefixes and leaf == "weight":
            val = 1.0 + 0.1 * z
        elif t.dim() >= 2:
            val = z * math.sqrt(2.0 / _fan_in(name, t.shape))
        else:
            val = 0.05 * z
        out[name] = val.contiguous()
    return out
