"""LLaVA architecture in PyTorch: CLIP vision tower, multimodal
projector, Mistral decoder with grouped-query attention, RoPE and
RMSNorm. Port of leafgrasp_tpu/vla/llava_jax.py, for serving and for
LoRA training (``vla/llava_trainer.py``).

The config's ``decoder`` may instead name ``"deepseek_v3"``: DeepSeek-V3's
decoder (Moonlight, Kimi-VL) behind the same tower and projector, with
latent attention (``vla/mla.py``) in every layer, a SwiGLU MLP in the
first ``first_k_dense_replace`` layers and routed and shared experts
(``vla/moe.py``) in the rest, served in the compute type (no LoRA, no
quantization), with a latent cache in place of K and V.

Types follow the JAX module operation by operation, so that a bf16 run
rounds where the JAX run rounds: a layer with a compute type casts its
input and its parameters to it; ``_RMSNorm`` normalizes in f32, casts
back, then multiplies by the weight in the promoted type; ``_rope_hf``
multiplies by f32 cos/sin and rounds once; attention scores, softmax and
their accumulation are f32, probabilities are cast to the layer input's
type before the second product; ``lm_head`` and the LoRA projections
have no compute type and work in the promoted type of input and weight.
With ``quantized=True`` the language model's projections and ``lm_head``
are the weight-only int8 / int4 layers of ``vla/quant.py``, which have
the compute type, as in the JAX module.

The prompt pass of a long batched prompt has three routes, chosen as the
JAX module chooses: ``"flash"`` (the CUDA kernel of
``kernels/flash_prefill``, with its backward kernels when autograd
records; the plain versions for CPU tensors), the dense
grouped einsum, and the same einsum over chunks of query rows. Each
decoder layer is told of its pass, its cache and the flash choice by a
``vla/layers.py`` ``Pass``; caches are a ``KVCache``, views of one
tensor for all layers, written in place. Pixel values are ``(B, H, W,
3)`` at every public function, as in the JAX package.

Greedy decode computes an image prefix that its rows share once
(``greedy_generate_llava``'s shared route), and on a CUDA device
replays one CUDA graph of its steps over static caches; elsewhere the
same steps run eagerly. A step's grouped-query attention goes through
``kernels/decode_attention`` (the kernel over the live slots of the
cache on the card, the dense masked attention on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from leafgrasp_tpu_torch.kernels import decode_attention as _da
from leafgrasp_tpu_torch.kernels import flash_prefill as _fp
from leafgrasp_tpu_torch.utils.device import resolve_device
from leafgrasp_tpu_torch.utils.profiler import span
from leafgrasp_tpu_torch.vla import moe
from leafgrasp_tpu_torch.vla.layers import (PROMPT, SHARED, STEP, KVCache,
                                            Pass, _apply_rope, _Dense,
                                            _matmul_f32, _rope_tables,
                                            _RMSNorm)
from leafgrasp_tpu_torch.vla.lora import LoRADense, PromotedLinear
from leafgrasp_tpu_torch.vla.quant import QuantDense, QuantLoRADense

__all__ = ["LlavaTorchConfig", "LlavaTorch", "convert_hf_llava_state_dict",
           "config_from_hf", "attach_lora", "init_random_",
           "random_llava_state", "iter_random_llava_state",
           "causal_mask", "greedy_generate_llava"]


@dataclasses.dataclass(frozen=True)
class LlavaTorchConfig:
    # vision (CLIP)
    vis_hidden: int = 1024
    vis_intermediate: int = 4096
    vis_layers: int = 24
    vis_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    vision_feature_layer: int = -2
    drop_cls_token: bool = True           # 'default' select strategy
    # text (Mistral)
    vocab_size: int = 32064
    hidden: int = 4096
    intermediate: int = 14336
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None   # Mistral local attention
    # fusion
    image_token_index: int = 32000
    # anyres grid pinpoints ((h, w) pairs; None for single-tile v1.5)
    image_grid_pinpoints: Optional[tuple] = None
    # compute type ("float32" | "bfloat16"); parameters stay as loaded,
    # activations and matrix products run in this type (norms and softmax
    # internally f32)
    dtype: str = "float32"
    # LoRA on the language model's q/k/v/o/gate/up/down projections
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_dropout: float = 0.0
    # weight-only quantized LM projections and lm_head (vla/quant.py); the
    # state must come from quantize_llava_variables with the same bits
    # and group. quant_bits: 8 (per-channel int8) or 4 (group-wise int4,
    # quant_group input rows a scale; ignored for int8)
    quantized: bool = False
    quant_bits: int = 8
    quant_group: int = 128
    # prompts longer than this compute attention in about this many query
    # rows at a time, so the f32 scores are (b, heads, chunk, total) and
    # not (b, heads, t, t). None disables chunking.
    prefill_attn_chunk: Optional[int] = 512
    # "chunked" (above) or "flash": the passes that vla/layers.py
    # Pass.flash admits go through kernels/flash_prefill (on the card it
    # raises for a head size or type its kernel lacks), the rest chunked
    prefill_attn_impl: str = "chunked"
    # the decoder: "mistral" (the fields above) or "deepseek_v3" (the
    # fields below with ``hidden``, ``intermediate`` (the dense layers'
    # width), ``layers``, ``heads``, ``rope_theta``, ``rms_eps``; DeepSeek's
    # names in the comments). No query compression (q_lora_rank null) and
    # one expert group (n_group = topk_group = 1): the sizes served.
    decoder: str = "mistral"
    kv_lora_rank: int = 0                  # the latent cached a token
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0         # leading dense layers
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True

    @property
    def mla(self) -> bool:
        return self.decoder == "deepseek_v3"

    @property
    def rope_dim(self) -> int:
        """The rotated columns of a query or key head."""
        return self.qk_rope_head_dim if self.mla else self.head_dim

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def config_from_hf(hf_config) -> "LlavaTorchConfig":
    """A HuggingFace LLaVA config object (any object with the same
    attributes) -> LlavaTorchConfig."""
    v = hf_config.vision_config
    t = hf_config.text_config
    deepseek = {}
    if getattr(t, "model_type", None) == "deepseek_v3":
        if getattr(t, "q_lora_rank", None) is not None \
                or getattr(t, "n_group", 1) != 1 \
                or getattr(t, "topk_group", 1) != 1:
            raise ValueError("deepseek_v3: query compression and expert "
                             "groups are not served")
        deepseek = dict(
            decoder="deepseek_v3", kv_lora_rank=t.kv_lora_rank,
            qk_nope_head_dim=t.qk_nope_head_dim,
            qk_rope_head_dim=t.qk_rope_head_dim, v_head_dim=t.v_head_dim,
            n_routed_experts=t.n_routed_experts,
            num_experts_per_tok=t.num_experts_per_tok,
            n_shared_experts=t.n_shared_experts,
            moe_intermediate_size=t.moe_intermediate_size,
            first_k_dense_replace=t.first_k_dense_replace,
            routed_scaling_factor=float(t.routed_scaling_factor),
            norm_topk_prob=bool(t.norm_topk_prob))
    return LlavaTorchConfig(**deepseek,
        vis_hidden=v.hidden_size, vis_intermediate=v.intermediate_size,
        vis_layers=v.num_hidden_layers, vis_heads=v.num_attention_heads,
        image_size=v.image_size, patch_size=v.patch_size,
        vision_feature_layer=hf_config.vision_feature_layer,
        drop_cls_token=(getattr(hf_config, "vision_feature_select_strategy",
                                "default") == "default"),
        vocab_size=t.vocab_size, hidden=t.hidden_size,
        intermediate=t.intermediate_size, layers=t.num_hidden_layers,
        heads=t.num_attention_heads, kv_heads=t.num_key_value_heads,
        rope_theta=float(getattr(t, "rope_theta", 10000.0)),
        rms_eps=float(getattr(t, "rms_norm_eps", 1e-6)),
        sliding_window=getattr(t, "sliding_window", None),
        image_token_index=hf_config.image_token_index,
        image_grid_pinpoints=tuple(
            tuple(p) for p in getattr(hf_config, "image_grid_pinpoints",
                                      None) or ()) or None,
    )


# ------------------------------------------------------ typed primitives --

def _layer_norm(x, ln: nn.LayerNorm, dt: torch.dtype):
    """LayerNorm with statistics and affine in f32, result in ``dt``."""
    y = F.layer_norm(x.to(torch.float32), ln.normalized_shape,
                     ln.weight.to(torch.float32), ln.bias.to(torch.float32),
                     ln.eps)
    return y.to(dt)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _einsum_promoted(eq: str, a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ------------------------------------------------------------ CLIP tower --

class _ClipAttention(nn.Module):
    def __init__(self, cfg: LlavaTorchConfig, **fk):
        super().__init__()
        self.cfg = cfg
        d = cfg.vis_hidden
        dt = cfg.torch_dtype
        self.q_proj = _Dense(d, d, dt, bias=True, **fk)
        self.k_proj = _Dense(d, d, dt, bias=True, **fk)
        self.v_proj = _Dense(d, d, dt, bias=True, **fk)
        self.out_proj = _Dense(d, d, dt, bias=True, **fk)

    def forward(self, x):
        c = self.cfg
        hd = c.vis_hidden // c.vis_heads
        b, t = x.shape[:2]

        def split(a):
            return a.reshape(b, t, c.vis_heads, hd)

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        scores = _matmul_f32("bthd,bshd->bhts", q, k)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _einsum_promoted("bhts,bshd->bthd", probs, v)
        return self.out_proj(out.reshape(b, t, c.vis_hidden))


class _ClipLayer(nn.Module):
    def __init__(self, cfg: LlavaTorchConfig, **fk):
        super().__init__()
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(cfg.vis_hidden, eps=1e-5, **fk)
        self.self_attn = _ClipAttention(cfg, **fk)
        self.layer_norm2 = nn.LayerNorm(cfg.vis_hidden, eps=1e-5, **fk)
        dt = cfg.torch_dtype
        self.fc1 = _Dense(cfg.vis_hidden, cfg.vis_intermediate, dt,
                          bias=True, **fk)
        self.fc2 = _Dense(cfg.vis_intermediate, cfg.vis_hidden, dt,
                          bias=True, **fk)

    def forward(self, x):
        dt = self.cfg.torch_dtype
        x = x + self.self_attn(_layer_norm(x, self.layer_norm1, dt))
        h = _layer_norm(x, self.layer_norm2, dt)
        return x + self.fc2(_quick_gelu(self.fc1(h)))


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: LlavaTorchConfig, **fk):
        super().__init__()
        self.cfg = cfg
        d = cfg.vis_hidden
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False,
                                         **fk)
        self.class_embedding = nn.Parameter(torch.zeros(d, **fk))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, d, **fk))
        self.pre_layrnorm = nn.LayerNorm(d, eps=1e-5, **fk)
        self.layers = nn.ModuleList(_ClipLayer(cfg, **fk)
                                    for _ in range(cfg.vis_layers))

    def forward(self, pixel_values):
        """pixel_values: (B, H, W, 3) -> selected hidden states
        (B, num_patches[+1], vis_hidden)."""
        c = self.cfg
        dt = c.torch_dtype
        b = pixel_values.shape[0]
        patches = F.conv2d(pixel_values.permute(0, 3, 1, 2).to(dt),
                           self.patch_embedding.weight.to(dt),
                           stride=c.patch_size)
        patches = patches.flatten(2).transpose(1, 2)     # (B, N, D)
        cls = self.class_embedding
        pt = torch.promote_types(cls.dtype, patches.dtype)
        x = torch.cat([cls.to(pt).expand(b, 1, c.vis_hidden),
                       patches.to(pt)], dim=1)
        x = (x + self.position_embedding[None]).to(dt)
        x = _layer_norm(x, self.pre_layrnorm, dt)

        # hidden_states = [embedding, after layer 0, ...]; take
        # [vision_feature_layer]. Layers past the kept one change nothing
        # that is returned, so they are not run.
        n_keep = c.vis_layers + 1 + c.vision_feature_layer \
            if c.vision_feature_layer < 0 else c.vision_feature_layer
        for layer in self.layers[:n_keep]:
            x = layer(x)
        return x[:, 1:] if c.drop_cls_token else x


# -------------------------------------------------------------- Mistral --

def _proj(in_features: int, features: int, cfg: LlavaTorchConfig, **fk):
    """Language-model projection: a plain bias-free linear layer, or
    LoRADense (frozen weight under ``base``) when a rank is configured;
    their int8 / int4 counterparts when ``cfg.quantized``."""
    if cfg.quantized:
        q = dict(dtype=cfg.torch_dtype, bits=cfg.quant_bits,
                 group=cfg.quant_group, device=fk["device"])
        if cfg.lora_rank > 0:
            return QuantLoRADense(in_features, features, rank=cfg.lora_rank,
                                  alpha=cfg.lora_alpha,
                                  dropout=cfg.lora_dropout,
                                  param_dtype=fk["dtype"],
                                  dropout_in_training=False, **q)
        return QuantDense(in_features, features, **q)
    if cfg.lora_rank > 0:
        # no dropout in training mode either: LlavaJax never passes
        # ``train`` to its LoRADense layers
        return LoRADense(in_features, features, rank=cfg.lora_rank,
                         alpha=cfg.lora_alpha, dropout=cfg.lora_dropout,
                         use_bias=False, dropout_in_training=False, **fk)
    return _Dense(in_features, features, cfg.torch_dtype, **fk)


def _rope_hf(x, positions, theta: float):
    """HF rotate_half convention: pairs split at half the head size.
    Angles, cos and sin are f32; the result is rounded to x's type once."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


class _MistralAttention(nn.Module):
    def __init__(self, cfg: LlavaTorchConfig, **fk):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _proj(cfg.hidden, cfg.heads * hd, cfg, **fk)
        self.k_proj = _proj(cfg.hidden, cfg.kv_heads * hd, cfg, **fk)
        self.v_proj = _proj(cfg.hidden, cfg.kv_heads * hd, cfg, **fk)
        self.o_proj = _proj(cfg.heads * hd, cfg.hidden, cfg, **fk)

    def forward(self, x, rope, pass_: Pass):
        """``rope``: the (cos, sin) of ``_rope_tables`` for this pass's
        positions; K and V are what a token leaves in the cache."""
        c = self.cfg
        hd = c.head_dim
        b, t = x.shape[:2]
        q = _apply_rope(self.q_proj(x).reshape(b, t, c.heads, hd), *rope)
        k = _apply_rope(self.k_proj(x).reshape(b, t, c.kv_heads, hd), *rope)
        v = self.v_proj(x).reshape(b, t, c.kv_heads, hd)
        out = pass_.attend(lambda: (k, v), lambda part, kv, p: self._attend(
            part(q), *kv, p, x.dtype))
        return self.o_proj(out.reshape(b, t, c.heads * hd))

    def _attend(self, q, k, v, p: Pass, dt):
        """(b, t, heads, hd) attention of the queries ``q`` (the key rows
        from the cursor ``p.cursor`` on) over the keys ``k``/``v`` under
        ``p.mask``, by the route the pass gives; probabilities in
        ``dt``."""
        c = self.cfg
        t = q.shape[1]
        tc = c.prefill_attn_chunk
        mask = p.mask
        kernel_dt = torch.promote_types(q.dtype, k.dtype)
        if p.decode_kernel():
            # the cache as it lies, its live slots only; on the card the
            # wrapper raises for a head size or type its kernel lacks
            out = _da.decode_attention(q, k, v, p.pad, p.cursor, dt,
                                       c.sliding_window)
            p.attended.add(_da.route(q.device))
        elif p.flash(c, t):
            # K/V go in as the cache holds them: kv_heads heads, the row
            # stride of the whole cache, the first cur + t rows read; the
            # queries are the key rows from the cursor on. On the card
            # the wrapper raises for a head size or type its kernel
            # lacks; nothing here gives way to another route for it. A
            # pass that autograd records goes through the kernels'
            # autograd Function, and the gradient through the casts
            out = _fp.flash_prefill_trainable(q.to(kernel_dt),
                                              k.to(kernel_dt),
                                              v.to(kernel_dt), p.pad,
                                              p.cursor)
        elif tc is None or t <= tc or not p.one_head(t):
            # chunking assumes a head-dim-1 mask; a per-head mask takes
            # the exact unchunked path
            out = _da.grouped_attention(q, k, v, mask, dt)
        else:
            # long prompt: query chunks of equal size, so the f32 scores
            # are (b, heads, tc, total)
            n = -(-t // tc)
            tc = -(-t // n)
            out = torch.cat([_da.grouped_attention(
                q[:, lo:lo + tc], k, v, mask[:, :, lo:lo + tc], dt)
                for lo in range(0, t, tc)], dim=1)
        return out


class _MistralLayer(nn.Module):
    def __init__(self, cfg: LlavaTorchConfig, **fk):
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.hidden, cfg.rms_eps, **fk)
        self.self_attn = _MistralAttention(cfg, **fk)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden, cfg.rms_eps,
                                                 **fk)
        self.gate_proj = _proj(cfg.hidden, cfg.intermediate, cfg, **fk)
        self.up_proj = _proj(cfg.hidden, cfg.intermediate, cfg, **fk)
        self.down_proj = _proj(cfg.intermediate, cfg.hidden, cfg, **fk)

    def forward(self, x, rope, pass_: Pass):
        x = x + self.self_attn(self.input_layernorm(x), rope, pass_)
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlavaTorch(nn.Module):
    """The whole model. ``device=None`` means CUDA (raises without it);
    ``param_dtype`` is the type the parameters are created in (they are
    left uninitialized: load a ``state_dict`` or call ``init_random_``).
    The vision tower and projector also run alone through
    ``vision_project`` (the JAX package's ``_VisionProject``)."""

    def __init__(self, cfg: LlavaTorchConfig, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.prefill_attn_impl not in ("chunked", "flash"):
            raise ValueError(f"prefill_attn_impl {cfg.prefill_attn_impl!r}")
        if cfg.decoder not in ("mistral", "deepseek_v3"):
            raise ValueError(f"decoder {cfg.decoder!r}")
        if cfg.mla and (cfg.lora_rank > 0 or cfg.quantized):
            raise ValueError("the deepseek_v3 decoder is served in its "
                             "compute type: no LoRA, no quantization")
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=param_dtype)
        self.vision_tower = ClipVisionTower(cfg, **fk)
        dt = cfg.torch_dtype
        self.mm_linear_1 = _Dense(cfg.vis_hidden, cfg.hidden, dt, bias=True,
                                  **fk)
        self.mm_linear_2 = _Dense(cfg.hidden, cfg.hidden, dt, bias=True, **fk)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden, **fk)
        self.layers = nn.ModuleList(_decoder_layer(cfg, i, **fk)
                                    for i in range(cfg.layers))
        self.norm = _RMSNorm(cfg.hidden, cfg.rms_eps, **fk)
        if cfg.quantized:
            self.lm_head = QuantDense(cfg.hidden, cfg.vocab_size,
                                      dtype=cfg.torch_dtype,
                                      bits=cfg.quant_bits,
                                      group=cfg.quant_group,
                                      device=fk["device"])
        else:
            self.lm_head = PromotedLinear(cfg.hidden, cfg.vocab_size,
                                          bias=False, **fk)
        if cfg.image_grid_pinpoints:
            # LLaVA-NeXT: the embedding that ends every row of the
            # unpadded feature grid
            self.image_newline = nn.Parameter(torch.zeros(cfg.hidden, **fk))
        else:
            self.image_newline = None
        self.eval()

    @classmethod
    def from_state(cls, cfg: LlavaTorchConfig, state: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> "LlavaTorch":
        """A model around the tensors of ``state`` as they are (no copy;
        the model lives where they do). Adapter leaves that ``state``
        lacks are drawn as ``attach_lora`` draws them, in f32 on that
        device: ``lora_a`` normal(1 / rank) from ``generator``, ``lora_b``
        zero. Raises for any other missing or unexpected key."""
        model = cls(cfg, device="meta")
        state = dict(state)
        dev = state["embed_tokens.weight"].device
        for name, p in model.named_parameters():
            if name in state:
                continue
            if name.endswith(".lora_a"):
                state[name] = torch.empty(p.shape, device=dev).normal_(
                    0.0, 1.0 / cfg.lora_rank, generator=generator)
            elif name.endswith(".lora_b"):
                state[name] = torch.zeros(p.shape, device=dev)
        model.load_state_dict(state, strict=True, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def set_prefill_attn(self, impl: str, chunk="keep") -> None:
        """Switch the prompt pass's attention route (and, if given, the
        chunk size) on this model, weights untouched."""
        if impl not in ("chunked", "flash"):
            raise ValueError(f"prefill_attn_impl {impl!r}")
        changes = {"prefill_attn_impl": impl}
        if chunk != "keep":
            changes["prefill_attn_chunk"] = chunk
        cfg = dataclasses.replace(self.cfg, **changes)
        for module in self.modules():
            if isinstance(getattr(module, "cfg", None), LlavaTorchConfig):
                module.cfg = cfg

    def vision_project(self, pixel_values):
        """(B, H, W, 3) pixel values -> (B, N, hidden) projected vision
        features."""
        feats = self.vision_tower(pixel_values)
        return self.mm_linear_2(F.gelu(self.mm_linear_1(feats)))

    def embed(self, input_ids, pixel_values=None, image_features=None):
        """(B, T) ids -> (B, T, hidden) text embedding in the compute type
        with the image-token rows replaced by projected vision features:
        the k-th image token of the flattened batch by the k-th feature
        row. ``image_features`` (.., hidden) may be given instead of
        pixels."""
        c = self.cfg
        x = F.embedding(input_ids, self.embed_tokens.weight) \
            .to(c.torch_dtype)

        if pixel_values is not None or image_features is not None:
            feats = image_features if image_features is not None \
                else self.vision_project(pixel_values)
            flat = feats.reshape(-1, c.hidden)
            is_img = input_ids == c.image_token_index
            img_order = torch.cumsum(is_img.reshape(-1).to(torch.int64),
                                     dim=0) - 1
            take = flat[torch.clamp(img_order, 0, flat.shape[0] - 1)] \
                .reshape(x.shape)
            pt = torch.promote_types(take.dtype, x.dtype)
            x = torch.where(is_img[..., None], take.to(pt), x.to(pt))
        return x

    def head(self, x, logits_last_only: bool = False):
        """The final norm and ``lm_head`` over the decoder's output; with
        ``logits_last_only`` the last position only (greedy decode reads
        no other)."""
        x = self.norm(x)
        if logits_last_only:
            x = x[:, -1:]
        return self.lm_head(x)

    def forward(self, input_ids, pixel_values=None, positions=None,
                mask=None, caches=None, image_features=None,
                logits_last_only: bool = False, pad=None):
        """input_ids: (B, T); pixel_values: (B, H, W, 3) or None (see
        ``embed``). ``mask`` None means causal (with the sliding window,
        if any). ``pad``: see ``Pass``. ``caches``: a ``KVCache`` that the
        pass fills from slot 0, or None. Returns (logits (B, T, vocab),
        caches)."""
        c = self.cfg
        x = self.embed(input_ids, pixel_values, image_features)
        b, t = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(t, device=dev).expand(b, t)
        if mask is None:
            mask, pad = causal_mask(c, b, t, dev)
        x = self.decoder(x, positions, Pass(PROMPT, mask, pad, cache=caches))
        return self.head(x, logits_last_only), caches

    def decoder(self, x, positions, pass_: Pass):
        """The decoder layers over the embedded ``x`` in ``pass_``: the
        hidden states before the final norm."""
        c = self.cfg
        rope = _rope_tables(positions, c.rope_dim, c.rope_theta)
        for i, layer in enumerate(self.layers):
            x = layer(x, rope, pass_.at(i))
        return x


def _decoder_layer(cfg: LlavaTorchConfig, i: int, **fk) -> nn.Module:
    if not cfg.mla:
        return _MistralLayer(cfg, **fk)
    return moe.DeepseekLayer(cfg, i, **fk)


def causal_mask(c: LlavaTorchConfig, b: int, t: int, dev):
    """The prompt pass's default mask, (1, 1, t, t) causal with the
    sliding window if any, and its ``pad``: (b,) zeros where the mask is
    purely causal (no window, or ``t`` within it), which lets the flash
    route run; None otherwise."""
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    if c.sliding_window is not None:
        qi = torch.arange(t, device=dev)[:, None]
        ki = torch.arange(t, device=dev)[None, :]
        mask = mask & (qi - ki < c.sliding_window)
    pad = None
    if c.sliding_window is None or t <= c.sliding_window:
        pad = torch.zeros((b,), dtype=torch.int32, device=dev)
    return mask[None, None], pad


# ------------------------------------------------------------ weights ----

def init_random_(model: LlavaTorch, generator: torch.Generator,
                 std: float = 0.02) -> LlavaTorch:
    """Fill every parameter in place from ``generator`` (on the model's
    device), in the parameter's own type, so a bf16 model never has an
    f32 copy: ``std * randn``, and ``1 + std * randn`` for the gains of
    the RMSNorm and LayerNorm layers. For serving measurements, where
    throughput does not depend on the values.

    The gains are drawn around one because with gains of ``std`` the
    branches see inputs of that scale, the residual stream is swamped by
    the average over the image tokens, and every candidate decodes the
    same tokens whatever its text; at unit gain activations have the
    scale of a trained model's and the text decides."""
    with torch.no_grad():
        for _, module, name, p in _init_order(model):
            _draw_(p, module, name, generator, std)
    return model


def _init_order(model: nn.Module):
    """(key, module, leaf name, parameter) in the order ``init_random_``
    draws them."""
    for prefix, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            yield (f"{prefix}.{name}" if prefix else name), module, name, p


def _draw_(t, module, name: str, generator, std: float) -> None:
    t.normal_(0.0, std, generator=generator)
    if name == "weight" and isinstance(module, (_RMSNorm, nn.LayerNorm)):
        t.add_(1.0)


def iter_random_llava_state(cfg: LlavaTorchConfig,
                            generator: torch.Generator, device=None,
                            param_dtype: torch.dtype = torch.float32,
                            std: float = 0.02):
    """Yield ``(key, tensor)`` for every entry of the ``state_dict`` that
    ``init_random_`` gives ``LlavaTorch(cfg, device, param_dtype)`` from
    ``generator``, one at a time in its draw order, so a caller that
    keeps or converts each tensor as it comes never holds the whole
    model. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    meta = LlavaTorch(cfg, device="meta", param_dtype=param_dtype)
    for key, module, name, p in _init_order(meta):
        t = torch.empty(p.shape, dtype=p.dtype, device=dev)
        with torch.no_grad():      # not across the yield: the caller's mode
            _draw_(t, module, name, generator, std)
        yield key, t


def random_llava_state(cfg: LlavaTorchConfig, generator: torch.Generator,
                       keep, device=None,
                       param_dtype: torch.dtype = torch.float32,
                       std: float = 0.02) -> Dict[str, torch.Tensor]:
    """The entries of ``iter_random_llava_state`` for the keys where
    ``keep(key)`` is true. Every other parameter is drawn and dropped, so
    the generator advances as under ``init_random_`` and the kept tensors
    equal its, while the whole model never exists: a pipeline rank draws
    its own stage and the replicated rest this way."""
    return {key: t for key, t in iter_random_llava_state(
        cfg, generator, device, param_dtype, std) if keep(key)}


def convert_hf_llava_state_dict(sd: Dict[str, Any],
                                cfg: LlavaTorchConfig) -> Dict[str, Any]:
    """HF LlavaForConditionalGeneration ``state_dict`` -> LlavaTorch
    ``state_dict``: a renaming of keys, nothing is transposed.

    Handles both transformers layouts ('model.vision_tower...' new and
    'vision_tower...' old prefixes, 'language_model.model.' nesting)."""
    sd = {(k[6:] if k.startswith("model.") else k): v
          for k, v in sd.items()}
    out: Dict[str, Any] = {}

    def lin(dst, src, bias=True, lora=False):
        out[f"{dst}.base.weight" if lora else f"{dst}.weight"] = \
            sd[src + ".weight"]
        if bias and src + ".bias" in sd:
            out[f"{dst}.bias"] = sd[src + ".bias"]

    vt = "vision_tower.vision_model"
    out["vision_tower.class_embedding"] = \
        sd[f"{vt}.embeddings.class_embedding"]
    out["vision_tower.position_embedding"] = \
        sd[f"{vt}.embeddings.position_embedding.weight"]
    out["vision_tower.patch_embedding.weight"] = \
        sd[f"{vt}.embeddings.patch_embedding.weight"]
    for name in ("weight", "bias"):
        out[f"vision_tower.pre_layrnorm.{name}"] = \
            sd[f"{vt}.pre_layrnorm.{name}"]
    for i in range(cfg.vis_layers):
        src, dst = f"{vt}.encoder.layers.{i}", f"vision_tower.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            for name in ("weight", "bias"):
                out[f"{dst}.{ln}.{name}"] = sd[f"{src}.{ln}.{name}"]
        for pr in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{dst}.self_attn.{pr}", f"{src}.self_attn.{pr}")
        lin(f"{dst}.fc1", f"{src}.mlp.fc1")
        lin(f"{dst}.fc2", f"{src}.mlp.fc2")

    lin("mm_linear_1", "multi_modal_projector.linear_1")
    lin("mm_linear_2", "multi_modal_projector.linear_2")

    lm = "language_model"
    if f"{lm}.model.embed_tokens.weight" in sd:   # old nesting
        lm = "language_model.model"
    out["embed_tokens.weight"] = sd[f"{lm}.embed_tokens.weight"]
    lora = cfg.lora_rank > 0      # adapters are overlaid by attach_lora
    for i in range(cfg.layers):
        src, dst = f"{lm}.layers.{i}", f"layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            out[f"{dst}.{ln}.weight"] = sd[f"{src}.{ln}.weight"]
        for pr in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin(f"{dst}.self_attn.{pr}", f"{src}.self_attn.{pr}",
                bias=False, lora=lora)
        for pr in ("gate_proj", "up_proj", "down_proj"):
            lin(f"{dst}.{pr}", f"{src}.mlp.{pr}", bias=False, lora=lora)
    out["norm.weight"] = sd[f"{lm}.norm.weight"]
    out["lm_head.weight"] = sd["lm_head.weight"]
    if "image_newline" in sd:     # LLaVA-NeXT per-row newline embedding
        out["image_newline"] = sd["image_newline"]
    return out


def attach_lora(model: LlavaTorch, state: Dict[str, Any],
                generator: torch.Generator) -> LlavaTorch:
    """Load converted base weights into a ``lora_rank > 0`` model and
    draw fresh adapters: ``lora_a`` normal(1 / rank), ``lora_b`` zero,
    so the adapter starts as no change. Adapter leaves that ``state``
    already holds win. A projection weight that ``state`` holds under
    its adapter-free name (``q_proj.weight``, from a model trained
    without adapters) goes into the frozen slot (``q_proj.base.weight``),
    as the JAX package's ``graft_base_params`` does."""
    rank = model.cfg.lora_rank
    state = dict(state)
    for name, _ in model.named_parameters():
        plain = name.replace(".base.weight", ".weight")
        if name.endswith(".base.weight") and name not in state \
                and plain in state:
            state[name] = state.pop(plain)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".lora_a"):
                p.normal_(0.0, 1.0 / rank, generator=generator)
            elif name.endswith(".lora_b"):
                p.zero_()
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing
               if not k.endswith((".lora_a", ".lora_b"))]
    if missing or unexpected:
        raise KeyError(f"state_dict does not fit: missing {missing}, "
                       f"unexpected {list(unexpected)}")
    return model


# ------------------------------------------------------------ generate ---

#: the graph route's caches hold the prompt and the new tokens rounded up
#: to a multiple of this many slots, so that a prompt a few tokens longer
#: or shorter replays the same graph
CACHE_QUANTUM = 64


def _generate_prefill(model: LlavaTorch, input_ids, pad, pixel_values,
                      image_features, cache: KVCache):
    """Prompt pass: fill ``cache`` (in the compute type, zero past the
    prompt; its capacity is the key axis). Returns the first greedy token
    and the pass."""
    c = model.cfg
    dev = input_ids.device
    t = input_ids.shape[1]
    slot = torch.arange(cache.capacity, device=dev)
    positions = torch.clamp(slot[None, :t] - pad[:, None], min=0)
    prompt = Pass(PROMPT, _da.slot_mask(slot[:t], slot, pad,
                                        c.sliding_window), pad,
                  cache=cache)
    x = model.decoder(model.embed(input_ids, pixel_values, image_features),
                      positions, prompt)
    logits = model.head(x, logits_last_only=True)
    return torch.argmax(logits[:, -1, :], dim=-1), prompt


def _generate_prefill_shared(model: LlavaTorch, input_ids, pad, pads,
                             image_features, cache: KVCache):
    """The prompt pass of rows that share one image, into the zeroed
    ``cache``: ``image_features`` (1, N, hidden) are the N tokens that
    follow each row's pad (``pads``, ``pad`` on the host).

    One pass over flat tokens: the N image tokens once, then every row's
    slots [N, t). Each layer runs the token-wise work once over them and
    writes the prefix's K/V (latents) into each row's slots [pad_r, N)
    and the text's into [N, t) (a ``SHARED`` ``Pass``); its attention runs
    the prefix over itself and the text over each row's keys from its
    pad, at cache cursor N. A row's slots from N start with its last
    pad_r image tokens (features N - pad_r on), which it recomputes:
    their features go in in that order.

    The slots before each row's pad stay as ``cache`` held them. Returns
    the first greedy token and the pass."""
    c = model.cfg
    dev = input_ids.device
    b, t = input_ids.shape
    n = image_features.shape[1]
    if any(t - p <= n for p in pads):
        raise ValueError(f"rows of {t} slots with pads {pads} do not all "
                         f"hold the {n} shared image tokens and a token "
                         f"after them")
    runs = []                       # rows of one pad before N, in runs
    for r, p in enumerate(pads):
        if runs and runs[-1][1] == r and runs[-1][2] == p:
            runs[-1] = (runs[-1][0], r + 1, p)
        elif p < n:
            runs.append((r, r + 1, p))
    ids = torch.full((1, n), c.image_token_index, dtype=input_ids.dtype,
                     device=dev)
    tail = [image_features[0, n - min(p, n):] for p in pads if p > 0]
    x = torch.cat([model.embed(ids, image_features=image_features),
                   model.embed(input_ids[:, n:],
                               image_features=torch.cat(tail) if tail
                               else None).reshape(1, b * (t - n), -1)],
                  dim=1)
    slot = torch.arange(t, device=dev)
    text = slot[n:]
    positions = torch.cat([slot[:n], torch.clamp(
        text[None, :] - pad[:, None], min=0).reshape(-1)])[None]
    shared = Pass(
        SHARED, cache=cache, n=n, t=t, runs=runs,
        prefix=Pass(SHARED, _da.slot_mask(slot[:n], slot[:n],
                                          window=c.sliding_window),
                    torch.zeros((1,), dtype=torch.int32, device=dev)),
        text=Pass(SHARED, _da.slot_mask(text, slot, pad, c.sliding_window),
                  pad, cursor=n))
    x = model.decoder(x, positions, shared)
    logits = model.head(shared.text_rows(x), logits_last_only=True)
    return torch.argmax(logits[:, -1, :], dim=-1), shared


def _generate_decode_step(model: LlavaTorch, cache: KVCache, last, pad,
                          step_i: int, prompt_len,
                          attended: Optional[set] = None):
    """One decode token against ``cache`` (written in place).
    ``prompt_len`` is a 0-d int64 tensor on the device: the rotary
    positions, the slot written and the key mask come from it, so a
    captured step serves any prompt that fits the cache. ``step_i`` is a
    Python int. ``attended``, if given, receives the route the step's
    attention took (``Pass.attended``)."""
    c = model.cfg
    dev = last.device
    pos = prompt_len + step_i
    positions = (pos - pad)[:, None]
    slot = pos.reshape(1)
    step = Pass(STEP, _da.slot_mask(slot, torch.arange(
        cache.capacity, device=dev), pad, c.sliding_window), pad,
        cursor=slot, cache=cache,
        attended=set() if attended is None else attended)
    x = model.decoder(model.embed(last[:, None]), positions, step)
    return torch.argmax(model.head(x)[:, -1, :], dim=-1)


def _decode_steps(model: LlavaTorch, cache: KVCache, last, pad, prompt_len,
                  n: int, attended: Optional[set] = None):
    """The ``n`` greedy tokens after ``last``, (b, n) int64: the loop that
    the graph route captures and the eager route runs. ``attended``, if
    given, receives the routes the steps' attention took."""
    toks = []
    for i in range(n):
        last = _generate_decode_step(model, cache, last, pad, i, prompt_len,
                                     attended)
        toks.append(last)
    if not toks:
        return last.new_zeros((last.shape[0], 0))
    return torch.stack(toks, dim=1)


class _DecodeGraph:
    """The decode loop of one (rows, capacity, steps), captured once as a
    CUDA graph over a static ``cache`` and static inputs, and replayed by
    every later call of that shape. ``attended``: the routes its captured
    steps' attention took."""

    def __init__(self, model: LlavaTorch, cache: KVCache, n: int, pool):
        dev, b = cache.data.device, cache.rows
        self.cache = cache
        self.last = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.pad = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.prompt_len = torch.zeros((), dtype=torch.int64, device=dev)
        self.attended: set = set()

        def loop():
            return _decode_steps(model, cache, self.last, self.pad,
                                 self.prompt_len, n, self.attended)

        # warm up on the capture's stream (cuBLAS's and the allocator's
        # lazy state), then capture. Both write slots 0 to n - 1, which
        # each call's zeroing and prompt pass overwrite before a replay.
        # The capture forbids unsafe calls on this thread only: the
        # service's callbacks may upload frames from theirs meanwhile
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            loop()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.attended.clear()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            self.out = loop()

    def replay(self, last, pad, prompt_len: int):
        """The loop's (b, n) tokens after ``last``: a copy of the graph's
        output, which the next replay overwrites."""
        self.last.copy_(last)
        self.pad.copy_(pad)
        self.prompt_len.fill_(prompt_len)
        self.graph.replay()
        return self.out.clone()


class _DecodeGraphs:
    """What the graph route keeps with a model: a ``KVCache`` for each
    (rows, capacity, compute type), a captured loop on them for each
    number of steps, one memory pool for the graphs, and the addresses
    of the parameters they were captured on. A graph reads the weights
    where they were at its capture, so once a parameter has moved
    everything is captured anew."""

    def __init__(self):
        self.caches: Dict[tuple, KVCache] = {}
        self.graphs: Dict[tuple, _DecodeGraph] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.params: tuple = ()

    def get(self, model: LlavaTorch, b: int, cap: int, n: int):
        """(the decode graph of this shape, "captured" where this call
        captured it, else "replayed")."""
        params = tuple(p.data_ptr() for p in model.parameters())
        if params != self.params:
            self.caches.clear()
            self.graphs.clear()
            self.params = params
        c = model.cfg
        key = (b, cap, c.torch_dtype)
        graph = self.graphs.get((*key, n))
        if graph is not None:
            return graph, "replayed"
        if key not in self.caches:
            self.caches[key] = KVCache(c, b, cap, model.device)
        with span("vla_graph_capture"):
            graph = _DecodeGraph(model, self.caches[key], n, self.pool)
        self.graphs[(*key, n)] = graph
        return graph, "captured"


def _decode_graphs(model: LlavaTorch, dev) -> Optional[_DecodeGraphs]:
    """The model's graph store where its decode replays a CUDA graph: on
    a CUDA device, for a model none of whose modules says
    ``graph_capturable = False`` (as the tensor-parallel projections of
    ``parallel/sharding.py`` do: a capture cannot hold their
    collectives). None where the steps run eagerly."""
    if dev.type != "cuda" or not all(getattr(m, "graph_capturable", True)
                                     for m in model.modules()):
        return None
    store = getattr(model, "_decode_graphs", None)
    if store is None:
        store = model._decode_graphs = _DecodeGraphs()
    return store


@torch.no_grad()
def greedy_generate_llava(model: LlavaTorch, input_ids, pixel_values=None,
                          image_features=None, max_new_tokens: int = 10,
                          pad_lens=None, decode_mode: str = "scan",
                          timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy decode: a prompt pass, then one single-token pass per
    further token. Returns (B, max_new_tokens) int32 on the model's
    device; nothing is read back to the host inside.

    pad_lens: optional (B,) LEFT-pad lengths for batched rows of unequal
    prompt length (right-aligned real tokens). Positions are
    pad-relative and attention never reads pad-slot keys, so every row
    decodes as it would alone: this is how the VLA scorer batches its
    candidate prompts into one pass over the weights.

    The prompt pass takes one of two routes, by the image features'
    shape and the row count. Features of one image, (1, N, hidden),
    under more than one row say that every row starts, after its pad,
    with those N image tokens: one pass then runs the prefix once,
    writes its K/V into every row, and runs the rows' text over them
    (``_generate_prefill_shared``; pad_lens are read on the host, so
    give them as a list or array, not on the card). Everything else
    (one row, no image, pixels, features flattened or of every row) is
    one pass over every slot of every row.

    The steps take one of two routes, by what the call can observe. On a
    CUDA device, for a model without the tensor-parallel projections of
    ``parallel/sharding.py``, the prompt pass writes into static caches
    held with the model, of ``prompt + max_new_tokens`` slots rounded up
    to a multiple of ``CACHE_QUANTUM``, and the steps replay one CUDA
    graph, captured on the first call of its (rows, capacity, steps)
    under the span ``vla_graph_capture``; such a model serves one call
    at a time. Everywhere else the steps run eagerly on fresh caches of
    exactly ``prompt + max_new_tokens`` slots. Both routes run
    ``_generate_decode_step``, which reads the prompt length from the
    device, over caches that hold zeros wherever no pass wrote.

    decode_mode: "scan" or "steps". The JAX package compiles them as one
    fused program or one program a token; here both take the route above
    and give the same tokens.

    timings: optional dict. It receives ``prefill_route``: "shared" or
    "full"; ``decode_graph``: "captured", "replayed" or "eager"; where
    the steps' attention took ``kernels/decode_attention`` (the
    grouped-query decoder's), ``decode_attention``: the route it took, as
    the steps' passes recorded it, eagerly or at the graph's capture:
    "kernel" (the CUDA kernel) or "plain" (its plain version); for a
    decoder with experts ``moe_load``, on the device: each expert
    layer's busiest expert's routed pairs over the mean, over the
    prompt; on a CUDA device also
    ``prefill_ms`` and ``decode_ms`` (CUDA events, one synchronization at
    the end, under the span ``device_wait``). The prompt pass runs under
    the span ``vla_prefill`` and the steps under ``vla_decode``: the
    host's time to launch them (on the graph route the replay), which for
    the steps includes any block on a launch queue the prefill still
    fills.
    """
    if decode_mode not in ("scan", "steps"):
        raise ValueError(f"decode_mode {decode_mode!r}: 'scan' or 'steps'")
    dev = input_ids.device
    b, t = input_ids.shape
    if pad_lens is None:
        pad = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        pad = torch.as_tensor(pad_lens).to(device=dev, dtype=torch.int32)
    shared = image_features is not None and image_features.dim() == 3 \
        and image_features.shape[0] == 1 and b > 1
    n = max_new_tokens - 1
    graphs = _decode_graphs(model, dev) if n > 0 else None
    graph, route = None, "eager"
    if graphs is not None:
        cap = -(-(t + max_new_tokens) // CACHE_QUANTUM) * CACHE_QUANTUM
        graph, route = graphs.get(model, b, cap, n)
    timed = timings is not None and dev.type == "cuda"
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    with span("vla_prefill"):
        if graph is None:
            cache = KVCache(model.cfg, b, t + max_new_tokens, dev)
        else:                       # what the last call left: zero it
            cache = graph.cache
            cache.zero_(t, cap - t)
        if shared:
            pads = [0] * b if pad_lens is None else \
                [int(p) for p in torch.as_tensor(pad_lens).tolist()]
            if graph is not None and max(pads) > 0:
                cache.zero_(0, max(pads))
            first, prompt = _generate_prefill_shared(
                model, input_ids, pad, pads, image_features, cache)
        else:
            first, prompt = _generate_prefill(model, input_ids, pad,
                                              pixel_values, image_features,
                                              cache)
        if timings is not None and prompt.routed:
            timings["moe_load"] = moe.moe_load(moe.expert_pairs(
                prompt.routed))
    if timed:
        ev[1].record()
    attended = set()
    with span("vla_decode"):
        if graph is None:
            steps = _decode_steps(model, cache, first, pad,
                                  torch.full((), t, dtype=torch.int64,
                                             device=dev), n, attended)
        else:
            steps = graph.replay(first, pad, t)
            attended = graph.attended
    out = torch.cat([first[:, None], steps], dim=1).to(torch.int32)
    if timed:
        ev[2].record()
        with span("device_wait"):
            ev[2].synchronize()
        timings["prefill_ms"] = ev[0].elapsed_time(ev[1])
        timings["decode_ms"] = ev[1].elapsed_time(ev[2])
    if timings is not None:
        timings["prefill_route"] = "shared" if shared else "full"
        timings["decode_graph"] = route
        if attended:
            timings["decode_attention"] = "+".join(sorted(attended))
    return out
