"""GPipe pipeline parallelism over the LLaVA decoder: the PyTorch port of
leafgrasp_tpu/parallel/pipeline.py, on ``torch.distributed``.

The ``layers`` Mistral blocks split into S stages of L/S contiguous
layers, S the size of one mesh axis; the rank at index s of that axis
holds stage s's layers only (``shard_stage_params``), which is what
makes pipeline parallelism the capacity axis: a model whose layers one
device cannot hold runs on S devices. The embedding and vision splice
below the stack and the final norm and ``lm_head`` above it (``rest``)
stay replicated, and are the model's own code (``LlavaTorch.embed`` and
``head``).

The batch splits into M microbatches. At step k of the M + S - 1 steps
stage s runs microbatch k - s and hands its output to stage s + 1
(``ShiftAlongAxis``: one list ``all_gather``, as gloo has no
``send`` / ``recv`` for CUDA tensors); the bubble is (S - 1) / (M + S - 1).
As in the JAX package, every rank computes every step, the bubble steps
on inputs nobody reads, so every rank records the same autograd graph
and issues the same collectives; the last stage's outputs then go to
every rank (``BroadcastFromAxis``). Autograd through this forward IS
pipeline backprop: the transpose of the shift is the reverse shift, the
last stage takes the replicated loss's gradient once, and the gradient
of the stage-0 input sums over the axis (``CopyToAxis``; only stage 0's
is non-zero), so the replicated embedding and vision tower get the
plain model's gradients on every rank.

With ``tp_axis`` each stage's layers are also Megatron-split over a
second mesh axis (``_TPMistralLayer``): q/k/v/gate/up by output columns,
o/down by input rows, each branch's partial sum restored by one
all-reduce before its residual add.

Scope, as the JAX module's: the prompt pass and the training forward,
no KV caches; decode stays on the tensor-parallel path
(``parallel/sharding.py``'s ``tensor_parallel_``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from leafgrasp_tpu_torch.parallel.collectives import (Axis,
                                                      BroadcastFromAxis,
                                                      CopyToAxis,
                                                      ReduceFromAxis,
                                                      ShiftAlongAxis)
from leafgrasp_tpu_torch.parallel.mesh import mesh_device
from leafgrasp_tpu_torch.vla.layers import (PROMPT, Pass, _apply_rope,
                                            _Dense, _matmul_f32,
                                            _rope_tables)
from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                 _einsum_promoted,
                                                 _MistralLayer, causal_mask)

__all__ = ["split_decoder_stages", "shard_stage_params",
           "make_pp_llava_forward"]

# Megatron's split of a decoder layer: these projections slice by output
# columns (each TP rank holds a head / intermediate slice), the others by
# input rows (their partial outputs sum over the TP axis)
_TP_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_TP_ROW = ("o_proj", "down_proj")


def split_decoder_stages(state, cfg, n_stages: int):
    """Split a ``LlavaTorch`` ``state_dict`` into (stages, rest), no
    tensor copied: ``stages[s]`` is an ``nn.ModuleList`` of the model's
    ``_MistralLayer``s ``s * L/S .. (s + 1) * L/S - 1`` around the
    state's tensors, and ``rest`` a ``LlavaTorch`` without decoder layers
    around every other tensor (embedding, vision tower and projector,
    final norm, ``lm_head``). Another stage's tensors may be on the
    ``meta`` device: only ``shard_stage_params`` touches a stage's
    values, and only its own rank's."""
    if cfg.layers % n_stages:
        raise ValueError(f"{cfg.layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    per = cfg.layers // n_stages
    stages = []
    for s in range(n_stages):
        layers = nn.ModuleList(_MistralLayer(cfg, device="meta",
                                             dtype=torch.float32)
                               for _ in range(per))
        sub = {}
        for j in range(per):
            prefix = f"layers.{s * per + j}."
            sub.update({f"{j}.{k[len(prefix):]}": v
                        for k, v in state.items() if k.startswith(prefix)})
        layers.load_state_dict(sub, strict=True, assign=True)
        stages.append(layers)
    rest = LlavaTorch.from_state(
        dataclasses.replace(cfg, layers=0),
        {k: v for k, v in state.items() if not k.startswith("layers.")})
    return stages, rest


def _slice_dense(lin: _Dense, dim: int, tp: Axis) -> _Dense:
    """This TP rank's slice of a bias-free projection: output rows
    (``dim`` 0) or input columns (``dim`` 1) of its ``(out, in)``
    weight, cloned."""
    if not isinstance(lin, _Dense):
        raise ValueError("tp_axis supports plain Dense layers only (no "
                         "quantized / LoRA TP stages)")
    w = lin.weight.detach().chunk(tp.size, dim)[tp.index].clone()
    out = _Dense(w.shape[1], w.shape[0], lin.compute_dtype, device="meta")
    out.weight = nn.Parameter(w, requires_grad=lin.weight.requires_grad)
    return out


class _TPMistralLayer(nn.Module):
    """This rank's Megatron slice of one ``_MistralLayer`` (JAX:
    ``_tp_layer_forward``): the local query and K/V heads and the local
    intermediate slice, norms whole. Attention is the dense softmax over
    the local heads, as in the JAX function, not the flash route. The
    o_proj and down_proj outputs are partial sums that one all-reduce
    each restores before the residual add."""

    def __init__(self, layer: _MistralLayer, tp: Axis):
        super().__init__()
        self.cfg = layer.self_attn.cfg
        self.tp = tp
        self.input_layernorm = layer.input_layernorm
        self.post_attention_layernorm = layer.post_attention_layernorm
        self.self_attn = nn.Module()
        for owner, dst in ((layer.self_attn, self.self_attn),
                           (layer, self)):
            for name, module in owner.named_children():
                if name in _TP_COL or name in _TP_ROW:
                    setattr(dst, name, _slice_dense(
                        module, 0 if name in _TP_COL else 1, tp))

    def forward(self, x, rope, pass_: Pass):
        hd = self.cfg.head_dim
        b, t = x.shape[:2]
        sa = self.self_attn
        h = CopyToAxis.apply(self.input_layernorm(x), self.tp)
        q = _apply_rope(sa.q_proj(h).reshape(b, t, -1, hd), *rope)
        k = _apply_rope(sa.k_proj(h).reshape(b, t, -1, hd), *rope)
        v = sa.v_proj(h).reshape(b, t, -1, hd)
        rep = q.shape[2] // k.shape[2]
        kr = torch.repeat_interleave(k, rep, dim=2)
        vr = torch.repeat_interleave(v, rep, dim=2)
        scores = _matmul_f32("bthd,bshd->bhts", q, kr) / math.sqrt(hd)
        scores = scores.masked_fill(~pass_.mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        out = _einsum_promoted("bhts,bshd->bthd", probs, vr)
        x = x + ReduceFromAxis.apply(sa.o_proj(out.reshape(b, t, -1)),
                                     self.tp)
        h = CopyToAxis.apply(self.post_attention_layernorm(x), self.tp)
        down = self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x + ReduceFromAxis.apply(down, self.tp)


def shard_stage_params(mesh, stages, axis: str = "data",
                       tp_axis: str | None = None) -> nn.ModuleList:
    """This rank's stage: ``stages[s]`` for its index s along ``axis``, on
    the mesh's device, and nothing of another stage. With ``tp_axis``, its
    layers' Megatron slices over that axis instead (``_TPMistralLayer``:
    q/k/v/gate/up weights by output rows of the ``(out, in)`` weight,
    o/down by input columns; cloned, so the caller may drop the whole
    stage). Pair with ``make_pp_llava_forward(..., tp_axis=...)``."""
    pp = Axis(mesh, axis)
    if len(stages) != pp.size:
        raise ValueError(f"{len(stages)} stages for a pipeline axis of "
                         f"{pp.size}")
    stage = stages[pp.index]
    if tp_axis is not None:
        tp = Axis(mesh, tp_axis)
        stage = nn.ModuleList(_TPMistralLayer(layer, tp) for layer in stage)
    return stage.to(mesh_device(mesh))


def _select(first: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` on the first stage, ``b`` elsewhere, in that one's type
    (JAX: ``where(s == 0, xs[idx], cur)``). Both stay in the autograd
    graph, so every rank's backward runs the hand-off's collective."""
    dt = a.dtype if first else b.dtype
    return torch.where(torch.tensor(first, device=a.device), a.to(dt),
                       b.to(dt))


def make_pp_llava_forward(mesh, model, n_microbatches: int,
                          axis: str = "data",
                          logits_last_only: bool = False,
                          remat: bool = False,
                          tp_axis: str | None = None):
    """The pipelined forward: ``fn(rest, stages, input_ids,
    pixel_values=None, image_features=None)`` -> logits (B, T, vocab), or
    (B, 1, vocab) with ``logits_last_only``, replicated on every rank.

    mesh           : the (data, model) ``DeviceMesh``; ``axis`` names the
                     pipeline dimension (S = its size stages).
    model          : a ``LlavaTorch`` (any device, ``meta`` too): its
                     config. Stages run the model's own ``_MistralLayer``
                     (bf16/f32, LoRA or quantized; the flash prefill where
                     the model's config routes a prompt pass to it).
    n_microbatches : M; the batch must divide by M.

    ``rest`` and ``stages`` come from ``split_decoder_stages`` and
    ``shard_stage_params``. ``remat=True`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant) when autograd records:
    only layer inputs stay alive through the schedule and the layer
    recomputes in the backward. ``tp_axis`` composes tensor parallelism
    within each stage (shard with ``shard_stage_params(...,
    tp_axis=...)``); heads, kv_heads and intermediate must divide its
    size, and the model must be plain (no LoRA, not quantized). There is
    no left pad: every row is ``t`` real tokens. ``fn.axis`` is the
    pipeline axis, whose ``calls`` and ``bytes`` count what a forward
    moved along it."""
    c = model.cfg
    pp = Axis(mesh, axis)
    n_stages = pp.size
    n_steps = n_microbatches + n_stages - 1
    if tp_axis is not None:
        tp = Axis(mesh, tp_axis).size
        if c.kv_heads % tp or c.heads % tp or c.intermediate % tp:
            raise ValueError(
                f"TP size {tp} must divide heads={c.heads}, "
                f"kv_heads={c.kv_heads} and intermediate={c.intermediate}")
        if c.quantized or c.lora_rank > 0:
            raise ValueError("tp_axis supports plain Dense layers only "
                             "(no quantized / LoRA TP stages)")

    def stage_apply(stage, h, rope, prompt):
        for layer in stage:
            if remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, rope, prompt, use_reentrant=False)
            else:
                h = layer(h, rope, prompt)
        return h

    def fn(rest, stages, input_ids, pixel_values=None, image_features=None):
        b, t = input_ids.shape
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by "
                             f"M={n_microbatches}")
        mb = b // n_microbatches
        x = rest.embed(input_ids, pixel_values, image_features)
        dev = x.device
        # purely causal (no window, or t within it): pad zeros let the
        # stage layers take the flash route, as LlavaTorch.forward does
        prompt = Pass(PROMPT, *causal_mask(c, mb, t, dev))
        rope = _rope_tables(torch.arange(t, device=dev).expand(mb, t),
                            c.head_dim, c.rope_theta)
        xs = CopyToAxis.apply(x, pp).reshape(n_microbatches, mb, t,
                                             c.hidden)
        s = pp.index
        cur = torch.zeros_like(xs[0])
        ys = []
        for k in range(n_steps):
            i = min(max(k - s, 0), n_microbatches - 1)
            y = stage_apply(stages, _select(s == 0, xs[i], cur), rope, prompt)
            ys.append(y)
            if k < n_steps - 1:
                cur = ShiftAlongAxis.apply(y, pp)
        # the last stage finishes microbatch i at step i + S - 1
        out = torch.stack(ys[n_stages - 1:])
        if logits_last_only:
            out = out[:, :, -1:]         # the norm is per position
        out = BroadcastFromAxis.apply(out.contiguous(), pp, n_stages - 1)
        return rest.head(out.reshape(b, -1, c.hidden))

    fn.axis = pp            # its calls and bytes count the hand-offs
    return fn
