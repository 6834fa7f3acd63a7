"""What ``LlavaTorch``'s two decoders (``llava_torch``'s Mistral layers,
``mla`` and ``moe``'s deepseek_v3 layers) share, below all three: typed
primitives, the cache (``KVCache``) and the pass every decoder layer is
told of (``Pass``), which decides in one place whether an attention
takes the flash kernel (``Pass.flash``) or the decode step's kernel
(``Pass.decode_kernel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["FLASH_MIN_TOKENS", "PROMPT", "SHARED", "STEP", "KVCache",
           "Pass"]

#: the fewest keys (cursor + queries) an attention takes the flash route at
FLASH_MIN_TOKENS = 128

PROMPT, SHARED, STEP = "prompt", "shared", "step"


class _Dense(nn.Linear):
    """A projection with a compute type (Flax's ``nn.Dense(dtype=dt)``):
    input, weight and bias cast to it. The language model's are
    bias-free."""

    def __init__(self, in_features, features, dt, bias: bool = False,
                 **fk):
        super().__init__(in_features, features, bias=bias, **fk)
        self.compute_dtype = dt

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _matmul_f32(eq: str, a, b):
    """einsum with f32 accumulation AND an f32 result (the JAX einsum
    with ``preferred_element_type=float32``): bf16 values are exact in
    f32, so the products are exact either way."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def _rope_tables(positions, d: int, theta: float):
    """f32 cos and sin of the rotary angles, (..., T, 1, d): the same
    for every layer of a pass, so a pass computes them once."""
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device)
                             * 2.0 / d))
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)[..., None, :]
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)[..., None, :]
    return cos, sin


def _apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rot * sin).to(x.dtype)


class KVCache:
    """Every decoder layer's cache as one zeroed tensor ``data`` in the
    compute type: K and V, (layers, 2, rows, capacity, kv_heads, hd), or
    the latents of latent attention, (layers, rows, capacity,
    kv_lora_rank + rope). ``layers[i]``: layer i's views of it, (rows,
    capacity, ...) each: (K, V), or (latents,)."""

    def __init__(self, cfg, rows: int, capacity: int, device):
        self.rows, self.capacity = rows, capacity
        shape = (cfg.layers, rows, capacity,
                 cfg.kv_lora_rank + cfg.qk_rope_head_dim) if cfg.mla \
            else (cfg.layers, 2, rows, capacity, cfg.kv_heads, cfg.head_dim)
        self.data = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
        self._slot_dim = 2 if cfg.mla else 3
        self.layers = [(d,) if cfg.mla else (d[0], d[1]) for d in self.data]

    def zero_(self, lo: int, n: int) -> None:
        """Zero slots lo .. lo + n - 1 of every row and layer."""
        self.data.narrow(self._slot_dim, lo, n).zero_()


@dataclasses.dataclass
class Pass:
    """What each decoder layer's ``forward(x, rope, pass_)`` is told of
    its pass. ``kind``: ``PROMPT``, every slot of every row from slot 0,
    with a cache or without (training, ``LlavaTorch.forward``);
    ``SHARED``, rows that share an image prefix as flat tokens (the ``n``
    prefix tokens once, then each row's slots [n, t)) into a cache;
    ``STEP``, one decode token a row at a cursor on the device, which a
    captured CUDA graph reads at each replay.

    ``mask`` (b or 1, 1 or heads, queries, keys). ``pad`` (b,) int32 is
    the caller's word that ``mask`` is exactly causal from the cursor
    (key <= cursor + query row) AND key >= pad, and on a step within the
    configuration's sliding window, if any, so that the flash route and
    the decode kernel may replace it by the pad lengths and the cursor;
    else None.
    ``cursor``: the first query's slot, 0 on a prompt pass, a (1,)
    tensor on a step. ``kv`` are a layer's views of ``cache`` (``at``).
    Expert layers add each call's routed pairs an expert to ``routed``;
    grouped-query attentions add the route their step took ("kernel" or
    "plain") to ``attended``.
    On the shared route ``runs`` are (lo, hi, p): rows lo .. hi - 1 of
    pad p < n; ``prefix`` and ``text`` are its two attentions' passes."""
    kind: str
    mask: Optional[torch.Tensor] = None
    pad: Optional[torch.Tensor] = None
    cursor: Any = 0
    cache: Optional[KVCache] = None
    kv: tuple = ()
    routed: list = dataclasses.field(default_factory=list)
    attended: set = dataclasses.field(default_factory=set)
    n: int = 0
    t: int = 0
    runs: Sequence[tuple] = ()
    prefix: Optional["Pass"] = None
    text: Optional["Pass"] = None

    def at(self, i: int) -> "Pass":
        """This pass at decoder layer ``i``, with its views of the cache."""
        if self.cache is None:
            return self
        return dataclasses.replace(self, kv=self.cache.layers[i])

    def one_head(self, t: int) -> bool:
        """Whether the mask has one head and ``t`` query rows."""
        m = self.mask
        return m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == t

    def causal(self, t: int) -> bool:
        """Whether the pad lengths and the cursor may replace the mask of
        ``t`` queries."""
        return self.pad is not None and self.one_head(t)

    def flash(self, cfg, t: int) -> bool:
        """Whether an attention of ``t`` queries in this pass takes the
        flash route (``kernels/flash_prefill``): the configured route, a
        mask that pad and cursor replace, at least ``FLASH_MIN_TOKENS``
        keys and a sliding window, if any, that the keys fit in. Never a
        step."""
        if cfg.prefill_attn_impl != "flash" or self.kind == STEP \
                or not self.causal(t):
            return False
        keys = self.cursor + t
        return keys >= FLASH_MIN_TOKENS and (cfg.sliding_window is None
                                             or keys <= cfg.sliding_window)

    def decode_kernel(self) -> bool:
        """Whether the grouped-query decoder's attention in this pass takes
        the decode step's route (``kernels/decode_attention``: the kernel
        on the card, its plain version on the CPU) in place of the mask:
        every step, whose ``pad`` the caller gives. Latent attention does
        not ask: its step keeps its mask and its absorbed form."""
        return self.kind == STEP

    def text_rows(self, x):
        """The shared route's flat tokens' text as (rows, t - n, ...)."""
        return x[0, self.n:].reshape(-1, self.t - self.n, *x.shape[2:])

    def attend(self, rows: Callable[[], Sequence[torch.Tensor]],
               attend: Callable):
        """A layer's attention output for this pass's tokens. ``rows()``
        gives what the tokens leave in each of the layer's cache tensors,
        in their order; ``attend(part, keys, p)`` is the layer's attention
        of the query rows that ``part`` takes from a query tensor over the
        key tensors ``keys`` under the pass ``p``. With a cache the rows
        are written first (cast to the cache's type: f32 parameters may
        widen them), from slot 0 on a prompt pass, at the cursor on a
        step, and the keys are the whole cache; without one, the rows."""
        if self.kind == SHARED:
            return self._shared(rows(), attend)
        keys = rows()
        if self.kv:
            for cache, row in zip(self.kv, keys):
                row = row.to(cache.dtype)
                if self.kind == STEP:
                    cache.index_copy_(1, self.cursor, row)
                else:
                    cache[:, :row.shape[1]] = row
            keys = self.kv
        return attend(lambda x: x, keys, self)

    def _shared(self, rows, attend):
        """The shared route's steps: the prefix's rows into each row's
        slots [pad, n), the text's into [n, t); then the prefix attends
        over its own rows, and each row's text over its cache's first t
        slots at the cursor n. Returns the flat tokens' output."""
        n, t = self.n, self.t
        rows = [row.to(cache.dtype) for cache, row in zip(self.kv, rows)]
        for cache, row in zip(self.kv, rows):
            for lo, hi, p in self.runs:
                cache[lo:hi, p:n] = row[:, :n - p]
            cache[:, n:t] = self.text_rows(row)
        out_p = attend(lambda x: x[:, :n], [row[:, :n] for row in rows],
                       self.prefix)
        out_t = attend(self.text_rows, [cache[:, :t] for cache in self.kv],
                       self.text)
        return torch.cat([out_p, out_t.reshape(1, -1, *out_t.shape[2:])],
                         dim=1)
