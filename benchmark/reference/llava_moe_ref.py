"""The plain float32 reference of the LLaVA-NeXT stack over DeepSeek-V3's
decoder (``moonshotai/Moonlight-16B-A3B`` config.json, ``model_type``
``deepseek_v3``), written from the published description (HF
``modeling_deepseek.py``): the CLIP tower, the projector and the anyres
packing of ``llava_ref`` (``llava_next_ref`` underneath), then

* latent attention without query compression: ``q_proj``; the latent
  ``kv_a_proj_with_mqa`` split into the 512 compressed columns, put
  through ``kv_a_layernorm`` (RMSNorm), and the 64 rope columns; per-head
  keys and values from ``kv_b_proj``; RoPE at theta 50000 on the
  de-interleaved rope columns (``apply_rotary_pos_emb``'s
  ``view(d // 2, 2).transpose``), one rope key for every head; softmax at
  scale 1 / sqrt(nope + rope) = 1 / sqrt(192), causal;
* a dense SwiGLU MLP in the first ``first_k_dense_replace`` layers;
* experts in the rest: sigmoid scores of the gate, the top
  ``num_experts_per_tok`` by score plus ``e_score_correction_bias``
  (``noaux_tc``, one group), their scores normalised to sum one and
  scaled by ``routed_scaling_factor``; each routed expert a SwiGLU of
  ``moe_intermediate_size``, computed expert by expert on its tokens;
  the ``n_shared_experts`` shared experts one SwiGLU of their summed
  width on every token;
* RMSNorm everywhere at ``rms_norm_eps``, an untied head.

Departures: none in the mathematics. As ``llava_ref`` it reads the
benchmark's drawn bf16 weights widened to float32 a layer at a time (an
expert at a time), computes in float32 with TF32 off, runs the rows'
shared image prefix once and each row's own tokens after it (causal
attention makes that the same computation as each row alone), and keeps
no cache: every served token's position is computed from the full
sequence. It imports no kernel of the port.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core.record import Limit
from benchmark.reference import llava_ref


class Weights(llava_ref.Weights):
    """``llava_ref.Weights`` with one routed expert's matrix on demand,
    rounded (under a control) per output channel as the others are."""

    def expert(self, key: str, e: int) -> torch.Tensor:
        return llava_ref.Weights({key: self.state[key][e]}, self.quantize,
                                 self.only)(key)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (..., T, heads, d), de-interleaved, then rotate-half."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return llava_ref._rope(x, pos, theta)


def _swiglu(h, wg, wu, wd):
    return F.linear(F.silu(F.linear(h, wg)) * F.linear(h, wu), wd)


def route(W, c, p: str, h: torch.Tensor):
    """(ids (N, k), weights (N, k)) of the gate of layer prefix ``p``."""
    scores = torch.sigmoid(F.linear(h, W(p + "mlp.gate.weight")))
    choice = scores + W(p + "mlp.gate.e_score_correction_bias")
    ids = torch.topk(choice, c.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, ids)
    if c.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return ids, w * c.routed_scaling_factor


def experts(W, c, p: str, h: torch.Tensor) -> torch.Tensor:
    """The expert layer of prefix ``p`` on rows ``h`` (N, hidden)."""
    ids, w = route(W, c, p, h)
    out = torch.zeros_like(h)
    for e in range(c.n_routed_experts):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], *(W.expert(f"{p}mlp.experts.{n}", e)
                              for n in ("gate_proj", "up_proj",
                                        "down_proj")))
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    s = p + "mlp.shared_experts."
    return out + _swiglu(h, *(W(s + n + ".weight")
                              for n in ("gate_proj", "up_proj",
                                        "down_proj")))


def mlp(W, c, i: int, h: torch.Tensor) -> torch.Tensor:
    """Layer ``i``'s MLP on (n, t, hidden)."""
    p = f"layers.{i}."
    if i < c.first_k_dense_replace:
        return _swiglu(h, *(W(f"{p}mlp.{n}.weight")
                            for n in ("gate_proj", "up_proj", "down_proj")))
    n, t = h.shape[:2]
    return experts(W, c, p, h.reshape(n * t, -1)).reshape(n, t, -1)


def qkv(W, c, i: int, x, pos):
    """Per-head q, k (nope + rope) and v of rows ``x`` (n, t, hidden) at
    positions ``pos``."""
    p = f"layers.{i}.self_attn."
    hh, r = c.heads, c.kv_lora_rank
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    h = _rms(x, W(f"layers.{i}.input_layernorm.weight"), c.rms_eps)
    n, t = x.shape[:2]
    q = F.linear(h, W(p + "q_proj.weight")).reshape(n, t, hh, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, c.rope_theta)], -1)
    ckv = F.linear(h, W(p + "kv_a_proj_with_mqa.weight"))
    lat = _rms(ckv[..., :r], W(p + "kv_a_layernorm.weight"), c.rms_eps)
    k_rope = _rope(ckv[..., None, r:], pos, c.rope_theta)
    kv = F.linear(lat, W(p + "kv_b_proj.weight")).reshape(n, t, hh, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope.expand(n, t, hh, dr)], -1)
    return q, k, kv[..., dn:]


def decoder_logits(W, c, prefix: torch.Tensor, suffix: torch.Tensor,
                   read_from: int) -> torch.Tensor:
    """Logits of the rows ``prefix`` (P, hidden) + ``suffix[r]`` (S,
    hidden) at the suffix positions from ``read_from`` on: (rows,
    S - read_from, vocab). A prefix of length 0 is allowed."""
    dev = suffix.device
    b, s = suffix.shape[:2]
    p_len = prefix.shape[0]
    p_pos = torch.arange(p_len, device=dev)
    s_pos = torch.arange(p_len, p_len + s, device=dev)
    xp, xs = prefix[None], suffix
    for i in range(c.layers):
        o_w = W(f"layers.{i}.self_attn.o_proj.weight")
        qp, kp, vp = qkv(W, c, i, xp, p_pos)
        qs, ks, vs = qkv(W, c, i, xs, s_pos)
        if p_len:
            ap = llava_ref._attend(qp, kp, vp, p_pos, p_pos, 1)
            xp = xp + F.linear(ap.reshape(1, p_len, -1), o_w)
        kall = torch.cat([kp.expand(b, -1, -1, -1), ks], dim=1)
        vall = torch.cat([vp.expand(b, -1, -1, -1), vs], dim=1)
        a_s = llava_ref._attend(qs, kall, vall, s_pos,
                                torch.cat([p_pos, s_pos]), 1)
        xs = xs + F.linear(a_s.reshape(b, s, -1), o_w)
        del o_w, qp, kp, vp, qs, ks, vs
        g_post = W(f"layers.{i}.post_attention_layernorm.weight")
        if p_len:
            xp = xp + mlp(W, c, i, _rms(xp, g_post, c.rms_eps))
        xs = xs + mlp(W, c, i, _rms(xs, g_post, c.rms_eps))
    h = _rms(xs[:, read_from:], W("norm.weight"), c.rms_eps)
    return F.linear(h, W("lm_head.weight"))


def calibrate(W, c, x: torch.Tensor, before_route) -> None:
    """Run rows ``x`` (n, t, hidden) through the decoder, calling
    ``before_route(p, h)`` with each expert layer's prefix and its gate's
    inputs h (n * t, hidden) before the layer routes (it may set that
    layer's router in the state ``W`` reads)."""
    n, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)
    for i in range(c.layers):
        q, k, v = qkv(W, c, i, x, pos)
        a = llava_ref._attend(q, k, v, pos, pos, 1)
        x = x + F.linear(a.reshape(n, t, -1),
                         W(f"layers.{i}.self_attn.o_proj.weight"))
        del q, k, v, a
        h = _rms(x, W(f"layers.{i}.post_attention_layernorm.weight"),
                 c.rms_eps)
        if i >= c.first_k_dense_replace:
            before_route(f"layers.{i}.", h.reshape(n * t, -1))
        x = x + mlp(W, c, i, h)


def rerank_logits(W, c, rec: dict, dev) -> torch.Tensor:
    """(rows, steps, vocab) reference logits at the positions where the
    rerank's served tokens were read (``llava_ref.rerank_logits`` over
    this decoder)."""
    n_img = int(rec["last"]["n_image_tokens"])
    feats = llava_ref.image_features(W, c, rec["image"], dev)
    assert feats.shape[0] == n_img, (feats.shape, n_img)
    served = [list(s) for s in rec["last"]["tokens"]]
    rows = [list(r) + s[:-1] for r, s in zip(rec["rows"], served)]
    t = n_img + len(rec["rows"][0])
    common = len(rows[0])
    for r in rows[1:]:
        k = 0
        while k < min(common, len(r)) and r[k] == rows[0][k]:
            k += 1
        common = k
    p_text = min(common, len(rec["rows"][0]) - 1)
    emb = W("embed_tokens.weight")
    prefix = torch.cat([feats, emb[torch.as_tensor(
        rows[0][:p_text], device=dev, dtype=torch.long)]], dim=0)
    suffix = emb[torch.as_tensor([r[p_text:] for r in rows], device=dev,
                                 dtype=torch.long)]
    del emb
    read_from = (t - 1) - (n_img + p_text)
    return decoder_logits(W, c, prefix, suffix, read_from)


@torch.no_grad()
def judge_reranks(rerank, seed: int, limits: dict, facts: dict
                  ) -> List[Limit]:
    """The served tokens of a seeded sample of the window's reranks
    against the reference: the mean gap of each candidate row (by its
    place in the batch, over the judged reranks, about 60 tokens), the
    worst row's beside the cell's limit; the mean over all judged
    tokens, the widest gap of one and the share the reference would
    pick too are facts."""
    llava_ref._no_tf32()
    recs = [r for r in rerank.records if r.get("ran") and not r["failed"]]
    n = rerank.check_reranks
    rng = np.random.default_rng([seed, 4])
    picks = sorted(rng.choice(len(recs), min(n, len(recs)), replace=False)) \
        if recs else []
    W = Weights(rerank.state)
    rows: dict = {}
    worst = 0.0
    for j in picks:
        rec = recs[j]
        logits = rerank_logits(W, rerank.cfg, rec, rerank.dev)
        gaps = llava_ref.token_gaps(logits, rec["last"]["tokens"])
        worst = max(worst, float(gaps.max()))
        for r, g in enumerate(gaps.to(torch.float64)):
            rows.setdefault(r, []).append(g)
        del logits
    row_means = {r: float(torch.cat(g).mean()) for r, g in rows.items()}
    every = torch.cat([x for g in rows.values() for x in g]) if rows \
        else torch.zeros(0)
    facts.update(reranks=float(len(recs)), reranks_judged=float(len(picks)),
                 served_tokens_judged=float(every.numel()),
                 token_gap_max=worst,
                 token_gap_mean=float(every.mean()) if every.numel() else 0.0,
                 token_agree=float((every == 0).to(torch.float64).mean())
                 if every.numel() else 0.0)
    return [Limit("reranks_judged_none", float(not picks), 0.0),
            Limit("token_gap_row_mean", max(row_means.values(), default=0.0),
                  limits["token_gap_row_mean"])]
