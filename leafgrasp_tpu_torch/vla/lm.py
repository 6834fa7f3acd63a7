"""TinyVLA: a Mistral-shaped vision-language decoder, inference half of
leafgrasp_tpu/vla/lm.py.

Byte-level tokenizer, a small convolutional encoder whose pooled
features are prefix tokens, RMSNorm, rotary attention with grouped K/V
heads (repeated to the query heads, as the JAX module does), SwiGLU MLP,
every projection a ``LoRADense``. ``greedy_generate`` fills a KV cache
in the prompt pass and then decodes one token a step; tokens stay on the
device until the end.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from leafgrasp_tpu_torch.utils.device import resolve_device
from leafgrasp_tpu_torch.vla.lora import LoRADense, PromotedLinear

__all__ = ["VLAModelConfig", "ByteTokenizer", "TinyVLA", "greedy_generate",
           "init_vla"]


@dataclasses.dataclass(frozen=True)
class VLAModelConfig:
    vocab_size: int = 260           # 256 bytes + specials
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    mlp_hidden: int = 256
    max_seq: int = 640
    rope_theta: float = 10000.0
    vision_tokens: int = 4
    vision_patch: int = 64          # input image resized to patch x patch
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


BOS, EOS, IMG = 256, 257, 258


class ByteTokenizer:
    """UTF-8 byte tokenizer with BOS/EOS/IMG specials."""

    vocab_size = 260
    bos, eos, img = BOS, EOS, IMG

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        by = bytes(int(i) for i in np.asarray(ids).ravel()
                   if 0 <= int(i) < 256)
        return by.decode("utf-8", errors="ignore")


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: (..., T, H, D). Rotary embedding in the split-half-pairs form:
    the frequency of pair ``i`` is ``theta ** (-i / half)``."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        var = torch.mean(x.to(torch.float32) ** 2, dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Attention(nn.Module):
    def __init__(self, cfg: VLAModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        lora = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                    dropout=cfg.lora_dropout, device=device)
        self.q_proj = LoRADense(cfg.dim, cfg.n_heads * hd, **lora)
        self.k_proj = LoRADense(cfg.dim, cfg.n_kv_heads * hd, **lora)
        self.v_proj = LoRADense(cfg.dim, cfg.n_kv_heads * hd, **lora)
        self.o_proj = LoRADense(cfg.n_heads * hd, cfg.dim, **lora)

    def forward(self, x, positions, mask, cache=None):
        cfg = self.cfg
        hd = cfg.head_dim
        b, t = x.shape[:2]
        q = self.q_proj(x).reshape(b, t, cfg.n_heads, hd)
        k = self.k_proj(x).reshape(b, t, cfg.n_kv_heads, hd)
        v = self.v_proj(x).reshape(b, t, cfg.n_kv_heads, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

        new_cache = None
        if cache is not None:
            ck, cv, cur = cache            # written in place
            ck[:, cur:cur + t] = k
            cv[:, cur:cur + t] = v
            k, v = ck, cv
            new_cache = (ck, cv, cur + t)

        rep = cfg.n_heads // cfg.n_kv_heads
        kr = torch.repeat_interleave(k, rep, dim=2)
        vr = torch.repeat_interleave(v, rep, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                              kr.to(torch.float32))
        scores = scores / math.sqrt(hd)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, vr)
        out = out.reshape(b, t, cfg.n_heads * hd)
        return self.o_proj(out), new_cache


class MLP(nn.Module):
    def __init__(self, cfg: VLAModelConfig, device=None):
        super().__init__()
        lora = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                    dropout=cfg.lora_dropout, device=device)
        self.gate_proj = LoRADense(cfg.dim, cfg.mlp_hidden, **lora)
        self.up_proj = LoRADense(cfg.dim, cfg.mlp_hidden, **lora)
        self.down_proj = LoRADense(cfg.mlp_hidden, cfg.dim, **lora)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: VLAModelConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.dim, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, mask, cache=None):
        h, new_cache = self.attn(self.attn_norm(x), positions, mask, cache)
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return x, new_cache


def _same_pad(n: int, kernel: int, stride: int):
    """(before, after) padding of XLA's SAME convolution."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class VisionEncoder(nn.Module):
    """Small conv encoder -> ``vision_tokens`` prefix embeddings."""

    def __init__(self, cfg: VLAModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        chans = (3, 16, 32, 64)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, device=device)
            for i in range(3))
        self.proj = nn.Linear(chans[-1], cfg.dim, device=device)

    def forward(self, image):
        # image: (B, P, P, C) float32 in [0, 1], channels last as in JAX
        x = image.permute(0, 3, 1, 2)
        for conv in self.convs:
            top, bottom = _same_pad(x.shape[2], 3, 2)
            left, right = _same_pad(x.shape[3], 3, 2)
            x = conv(F.pad(x, (left, right, top, bottom)))
            x = F.gelu(x, approximate="tanh")
        b, c = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, c)
        x = x.reshape(b, self.cfg.vision_tokens, -1, c).mean(dim=2)
        return self.proj(x)                  # (B, V, dim)


class TinyVLA(nn.Module):
    """``device=None`` means CUDA and raises without it; the parameters
    are PyTorch's default draws (load a ``state_dict`` or use
    ``init_vla``)."""

    def __init__(self, cfg: VLAModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.vision = VisionEncoder(cfg, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, device=device)
        self.lm_head = PromotedLinear(cfg.dim, cfg.vocab_size, bias=False,
                                      device=device)

    def forward(self, tokens, image=None, positions=None, mask=None,
                caches=None):
        """tokens: (B, T) integers. image: (B, P, P, C) or None.
        Returns (logits (B, T', vocab), new_caches). When an image is
        given, vision prefix tokens are prepended to the sequence."""
        x = self.tok_emb(tokens)
        if image is not None:
            x = torch.cat([self.vision(image), x], dim=1)
        b, t = x.shape[:2]
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        if mask is None:
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                         device=x.device))[None, None]
        new_caches = []
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc = layer(x, positions, mask, cache)
            new_caches.append(nc)
        logits = self.lm_head(self.final_norm(x))
        return logits, (new_caches if caches is not None else None)


def init_vla(seed: int, cfg: VLAModelConfig, device=None) -> TinyVLA:
    """A TinyVLA in eval mode with weights drawn from ``seed``: normal
    with deviation ``fan_in ** -0.5`` for matrices and convolutions,
    adapter ``lora_a`` normal(1 / rank) and ``lora_b`` zero, norms one,
    biases zero. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    model = TinyVLA(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "lora_a":
                p.normal_(0.0, 1.0 / cfg.lora_rank, generator=gen)
            elif leaf == "lora_b" or leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif name == "tok_emb.weight":
                p.normal_(0.0, 1.0, generator=gen)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=gen)
    return model.eval()


@torch.no_grad()
def greedy_generate(model: TinyVLA, tokens: torch.Tensor, image=None,
                    max_new_tokens: int = 10) -> torch.Tensor:
    """Greedy decode. tokens: (B, T) prompt. Returns (B, max_new_tokens)
    on the model's device.

    The prompt pass fills the KV cache (f32, written in place); each
    further token is one single-token pass. The argmax stays on the
    device: nothing is read back inside the loop."""
    cfg = model.cfg
    dev = tokens.device
    b, t = tokens.shape
    prefix = cfg.vision_tokens if image is not None else 0
    tp = t + prefix
    total = tp + max_new_tokens
    caches = [(torch.zeros((b, total, cfg.n_kv_heads, cfg.head_dim),
                           dtype=torch.float32, device=dev),
               torch.zeros((b, total, cfg.n_kv_heads, cfg.head_dim),
                           dtype=torch.float32, device=dev), 0)
              for _ in range(cfg.n_layers)]
    positions = torch.arange(tp, device=dev).expand(b, tp)
    causal = torch.tril(torch.ones((tp, total), dtype=torch.bool,
                                   device=dev))[None, None]
    logits, caches = model(tokens, image=image, positions=positions,
                           mask=causal, caches=caches)
    last = torch.argmax(logits[:, -1, :], dim=-1)
    toks = [last]
    key_idx = torch.arange(total, device=dev)
    for i in range(max_new_tokens - 1):
        pos = tp + i
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
        mask = (key_idx <= pos)[None, None, None, :]
        logits, caches = model(last[:, None], positions=positions,
                               mask=mask, caches=caches)
        last = torch.argmax(logits[:, -1, :], dim=-1)
        toks.append(last)
    return torch.stack(toks, dim=1).to(torch.int32)
