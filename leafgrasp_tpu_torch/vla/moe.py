"""Mixture of experts and the decoder layer of ``LlavaTorch``'s
``deepseek_v3`` decoder (DeepSeek-V3's ``DeepseekV3MoE`` and
``DeepseekV3DecoderLayer``, as Moonlight configures them).

The router works in f32: ``s = sigmoid(x W_r^T)``; the experts are
chosen by ``s + b`` (``e_score_correction_bias``, ``noaux_tc`` with one
group), the top ``num_experts_per_tok``; their weights are their ``s``,
normalised to sum to one (``norm_topk_prob``) and scaled by
``routed_scaling_factor``. The routed experts run through one grouped
kernel (``kernels/moe_experts``) in the prompt pass and in the decode
alike; the ``n_shared_experts`` shared experts are one SwiGLU of their
summed width, added to every token. Nothing here reads a value back to
the host, so a prompt pass does not stall and a decode step can be
captured in a CUDA graph.

A layer of the first ``first_k_dense_replace`` is a dense SwiGLU of
``intermediate``; every later layer has experts. An expert layer adds
its pair count of each expert, on the device, to its pass's ``routed``
(``vla/layers.py`` ``Pass``), which ``expert_pairs`` stacks and
``moe_load`` turns into the load of the pass.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from leafgrasp_tpu_torch.kernels import moe_experts as _moe
from leafgrasp_tpu_torch.vla.layers import Pass, _Dense, _RMSNorm
from leafgrasp_tpu_torch.vla.mla import MLAttention

__all__ = ["Router", "Experts", "SwiGLU", "MoE", "DeepseekLayer",
           "expert_pairs", "moe_load"]


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))`` in the compute type."""

    def __init__(self, hidden: int, width: int, dt, **fk):
        super().__init__()
        self.gate_proj = _Dense(hidden, width, dt, **fk)
        self.up_proj = _Dense(hidden, width, dt, **fk)
        self.down_proj = _Dense(width, hidden, dt, **fk)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """DeepSeek-V3's gate: ``forward(x)`` -> (ids (T, k) int64, weights
    (T, k) f32)."""

    def __init__(self, cfg, **fk):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(
            (cfg.n_routed_experts, cfg.hidden), **fk))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(
            (cfg.n_routed_experts,), **fk))

    def forward(self, x):
        c = self.cfg
        f32 = torch.float32
        scores = torch.sigmoid(F.linear(x.to(f32), self.weight.to(f32)))
        choice = scores + self.e_score_correction_bias.to(f32)
        ids = torch.topk(choice, c.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, ids)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return ids, w * c.routed_scaling_factor


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked: ``gate_proj`` and
    ``up_proj`` (E, width, hidden), ``down_proj`` (E, hidden, width)."""

    def __init__(self, cfg, **fk):
        super().__init__()
        e, w, h = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden
        self.gate_proj = nn.Parameter(torch.empty((e, w, h), **fk))
        self.up_proj = nn.Parameter(torch.empty((e, w, h), **fk))
        self.down_proj = nn.Parameter(torch.empty((e, h, w), **fk))


class MoE(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg, **fk)
        self.experts = Experts(cfg, **fk)
        self.shared_experts = SwiGLU(
            cfg.hidden, cfg.moe_intermediate_size * cfg.n_shared_experts,
            cfg.torch_dtype, **fk)

    def forward(self, x, pairs: Optional[list] = None):
        """``pairs``, where given, receives the call's routed pairs an
        expert, (experts,) on the device."""
        c = self.cfg
        dt = c.torch_dtype
        b, t, hidden = x.shape
        flat = x.reshape(b * t, hidden).to(dt)
        ids, w = self.gate(flat)
        counts = _moe.expert_counts(ids, c.n_routed_experts)
        if pairs is not None:
            pairs.append(counts)
        ex = self.experts
        routed = _moe.moe_experts(flat, ids, w, ex.gate_proj.to(dt),
                                  ex.up_proj.to(dt), ex.down_proj.to(dt),
                                  counts=counts)
        return routed.reshape(b, t, hidden) + self.shared_experts(x)


class DeepseekLayer(nn.Module):
    """Pre-norm residual layer: latent attention, then a dense SwiGLU
    (``i < first_k_dense_replace``) or the experts."""

    def __init__(self, cfg, i: int, **fk):
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.hidden, cfg.rms_eps, **fk)
        self.self_attn = MLAttention(cfg, **fk)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden, cfg.rms_eps,
                                                 **fk)
        self.mlp = SwiGLU(cfg.hidden, cfg.intermediate, cfg.torch_dtype,
                          **fk) if i < cfg.first_k_dense_replace \
            else MoE(cfg, **fk)

    def forward(self, x, rope, pass_: Pass):
        x = x + self.self_attn(self.input_layernorm(x), rope, pass_)
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            return x + self.mlp(h, pass_.routed)
        return x + self.mlp(h)


def expert_pairs(routed: list) -> torch.Tensor:
    """(expert layers, experts) f32 on the device: the routed pairs an
    expert that each expert layer added to a pass's ``routed``."""
    return torch.stack(routed).to(torch.float32)


def moe_load(pairs: torch.Tensor) -> torch.Tensor:
    """(expert layers,) f32 on the device: of ``expert_pairs`` (one pass,
    or the passes of one prompt summed), each layer's busiest expert's
    routed pairs over the mean pairs an expert."""
    return pairs.amax(dim=1) / pairs.mean(dim=1).clamp(min=1e-30)
