"""Latent attention (DeepSeek-V2/V3's MLA, as Moonlight and Kimi-VL use
it) for ``LlavaTorch``'s ``deepseek_v3`` decoder, without query
compression:

    q      = q_proj(x)                      (heads, nope + rope)
    c, k_r = kv_a_proj_with_mqa(x)          (kv_lora_rank), (rope)
    c      = kv_a_layernorm(c)              RMSNorm of the latent
    k_n, v = kv_b_proj(c)                   (heads, nope), (heads, v)
    q_r, k_r rotated (one k_r for every head); scale 1 / sqrt(nope + rope)
    out    = o_proj(softmax(q . [k_n, k_r] scale) v)

RoPE follows HF ``modeling_deepseek.py`` ``apply_rotary_pos_emb``: the
rope columns are de-interleaved (even ones, then odd ones) before the
rotate-half rotation. A layer's cache is one tensor, (b, total,
kv_lora_rank + rope): the normalised latent and the rotated k_r of each
token, shared by every head.

The form follows the pass's kind (``vla/layers.py`` ``Pass``). A prompt
pass expands its own latents to per-head K (nope + rope) and V and
attends over the prompt. On the shared route of rows that share an image
a layer expands twice: the prefix's latents as cached, and each row's
cached latents for its text, whose queries sit at the prefix's offset on
the key axis. Both go through ``kernels/flash_prefill`` (its split-head
instantiation on the card) on the ``"flash"`` route, else its plain
version or a masked einsum. A decode step takes the absorbed form over
the whole cache: ``kv_b_proj``'s key half folded into the query, its
value half applied after the sum, so that every head reads the one
shared latent; scores and sums in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from leafgrasp_tpu_torch.kernels import flash_prefill as _fp
from leafgrasp_tpu_torch.vla.layers import (PROMPT, STEP, Pass, _apply_rope,
                                            _Dense, _matmul_f32, _RMSNorm)

__all__ = ["MLAttention", "deinterleave"]


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The last dimension's even columns, then its odd ones (HF
    ``modeling_deepseek.py``: ``view(..., d // 2, 2).transpose``)."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _attend_masked(q, k, v, mask, scale: float):
    """Exact attention, f32 scores and softmax, probabilities cast to the
    input's type before the second product: q (b, t, h, dk), k (b, s, h,
    dk), v (b, s, h, dv), mask (b or 1, 1, t, s)."""
    scores = _matmul_f32("bthd,bshd->bhts", q, k) * scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.to(dt), v.to(dt))


class MLAttention(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        h = cfg.heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        r = cfg.kv_lora_rank
        self.q_proj = _Dense(cfg.hidden, h * (dn + dr), dt, **fk)
        self.kv_a_proj_with_mqa = _Dense(cfg.hidden, r + dr, dt, **fk)
        self.kv_a_layernorm = _RMSNorm(r, cfg.rms_eps, **fk)
        self.kv_b_proj = _Dense(r, h * (dn + dv), dt, **fk)
        self.o_proj = _Dense(h * dv, cfg.hidden, dt, **fk)

    def forward(self, x, rope, pass_: Pass):
        """As ``_MistralAttention.forward``; what a token leaves in the
        cache is ``_cache_row``."""
        c = self.cfg
        h, r = c.heads, c.kv_lora_rank
        dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        b, t = x.shape[:2]
        scale = 1.0 / math.sqrt(dn + dr)
        q = self.q_proj(x).reshape(b, t, h, dn + dr)
        q_nope = q[..., :dn]
        q_rope = _apply_rope(deinterleave(q[..., dn:]), *rope)
        ckv = self.kv_a_proj_with_mqa(x)
        lat = self.kv_a_layernorm(ckv[..., :r])
        k_rope = _apply_rope(deinterleave(ckv[..., None, r:]), *rope)

        def attend(part, keys, p: Pass):
            if p.kind == STEP:
                return self._absorbed(q_nope, q_rope, keys[0], p.mask, scale)
            if p.kind == PROMPT:     # its own latents, not their cast
                return self._expanded(q_nope, q_rope, lat, k_rope, p, scale)
            lk = keys[0]
            return self._expanded(part(q_nope), part(q_rope), lk[..., :r],
                                  lk[..., None, r:], p, scale)

        out = pass_.attend(lambda: (self._cache_row(ckv, lat, k_rope),),
                           attend)
        return self.o_proj(out.reshape(b, t, h * dv))

    def _expanded(self, q_nope, q_rope, lat, k_rope, p: Pass, scale):
        """(b, t, heads, v) attention of the queries (the key rows from
        the cursor ``p.cursor`` on) over the keys' latents ``lat`` (b,
        cursor + t, rank) and rotated ``k_rope`` expanded to per-head K
        and V."""
        c = self.cfg
        h, dn, dr, dv = c.heads, c.qk_nope_head_dim, c.qk_rope_head_dim, \
            c.v_head_dim
        b, t = q_nope.shape[:2]
        s = p.cursor + t
        kv = self.kv_b_proj(lat).reshape(b, s, h, dn + dv)
        k = torch.cat([kv[..., :dn], k_rope.expand(b, s, h, dr)
                       .to(kv.dtype)], dim=-1)
        qq = torch.cat([q_nope, q_rope.to(q_nope.dtype)], dim=-1)
        v = kv[..., dn:]
        if p.flash(c, t):
            # on the card the split-head kernel (q/k 192, v 128 in bf16);
            # it raises for sizes or types it lacks
            out = _fp.flash_prefill(qq, k, v, p.pad, p.cursor)
        elif p.causal(t):
            out = _fp.flash_prefill_plain(qq, k, v, p.pad, p.cursor,
                                          chunk=c.prefill_attn_chunk)
        else:
            out = _attend_masked(qq, k, v, p.mask[..., :s], scale)
        return out

    def _cache_row(self, ckv, lat, k_rope):
        """What a token leaves in the cache: its normalised latent and
        its rotated rope key."""
        return torch.cat([lat, k_rope[:, :, 0]], dim=-1)

    def _absorbed(self, q_nope, q_rope, lc, mask, scale):
        """(b, t, heads, v) attention of the queries over the whole latent
        cache ``lc`` under ``mask`` (b or 1, 1, t, total)."""
        c = self.cfg
        h, r, dn = c.heads, c.kv_lora_rank, c.qk_nope_head_dim
        w = self.kv_b_proj.weight.reshape(h, -1, r)
        q_lat = _matmul_f32("bthd,hdr->bthr", q_nope, w[:, :dn])
        lat = lc[..., :r].to(torch.float32)
        scores = (torch.einsum("bthr,bsr->bhts", q_lat, lat)
                  + _matmul_f32("bthd,bsd->bhts", q_rope, lc[..., r:])) \
            * scale
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", probs, lat)
        out = torch.einsum("bthr,hvr->bthv", o_lat,
                           w[:, dn:].to(torch.float32))
        return out.to(q_nope.dtype)
