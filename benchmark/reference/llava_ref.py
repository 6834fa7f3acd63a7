"""The plain float32 reference of LLaVA-1.6 with the Mistral decoder,
written from the published architecture (``llava-hf/llava-v1.6-mistral-
7b-hf``): the CLIP ViT-L/14-336 tower (pre-LayerNorm, quick-GELU MLP,
the second-to-last layer's patch features), the two-layer GELU
projector, the anyres tiles and packing (``llava_next_ref``, a frozen
copy of the port's), and the Mistral decoder (RMSNorm, rotate-half RoPE
at theta 1e6, grouped-query attention, SiLU-gated MLP, untied head).

It reads the benchmark's drawn bf16 weights, widened to float32 a layer
at a time, and computes in float32 with TF32 off. The rows of a rerank
share their image prefix; the reference runs that prefix once and each
row's own tokens after it (causal attention makes this the same
computation as each row alone). ``Weights(state, "fp8")`` swaps every
matrix for its per-output-channel float8 rounding: the control.

The served tokens are judged by the gap by which each one's logit lies
below the reference's best logit at its position (0 where the reference
would pick it too).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core.record import Limit
from benchmark.reference import llava_next_ref as nx


_LM_MATRIX = re.compile(r"^(layers\.\d+\.(self_attn\.)?(q|k|v|o|gate|up|down)"
                        r"_proj|lm_head)\.weight$")


class Weights:
    """The state's tensors as float32 on demand. ``quantize`` rounds
    the matrices that ``only`` accepts (every tensor of two or more
    dimensions by default) first, per output channel: ``"int8"``
    symmetric at max|w| / 127, half to even, ``"fp8"`` to float8 e4m3 at
    max|w| / 448 (the control)."""

    def __init__(self, state: Dict[str, torch.Tensor], quantize=None,
                 only=None):
        self.state, self.quantize = state, quantize
        self.only = only or (lambda key: True)

    def __call__(self, key: str) -> torch.Tensor:
        w = self.state[key].to(torch.float32)
        if self.quantize and w.dim() >= 2 and self.only(key):
            flat = w.reshape(w.shape[0], -1)
            amax = flat.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
            if self.quantize == "int8":
                scale = amax / 127.0
                q = torch.round(flat / scale).clamp(-127, 127)
            else:
                scale = amax / 448.0
                q = (flat / scale).to(torch.float8_e4m3fn).to(torch.float32)
            w = (q * scale).reshape(w.shape)
        return w


def served_weights(state: Dict[str, torch.Tensor], quantize=None
                   ) -> Weights:
    """The weights as the configuration serves them: as drawn, or, under
    a ``quantize`` entry of 8 bits, the decoder's projections and head
    rounded to int8 per output channel (the tower, projector, embedding
    and norms as drawn)."""
    if not quantize:
        return Weights(state)
    if int(quantize["bits"]) != 8:
        raise ValueError(f"no reference for {quantize}")
    return Weights(state, "int8", only=_LM_MATRIX.match)


def _lin(x, W, name, bias=True):
    return F.linear(x, W(name + ".weight"),
                    W(name + ".bias") if bias else None)


def _ln(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W(name + ".weight"),
                        W(name + ".bias"), 1e-5)


def tower(W, c, tiles: torch.Tensor) -> torch.Tensor:
    """(n, 336, 336, 3) normalized tiles -> (n, 576, hidden) projected
    features."""
    p = "vision_tower."
    x = F.conv2d(tiles.permute(0, 3, 1, 2), W(p + "patch_embedding.weight"),
                 stride=c.patch_size)
    x = x.flatten(2).transpose(1, 2)
    n, _, d = x.shape
    x = torch.cat([W(p + "class_embedding").expand(n, 1, d), x], dim=1)
    x = x + W(p + "position_embedding")[None]
    x = _ln(x, W, p + "pre_layrnorm")
    heads, hd = c.vis_heads, d // c.vis_heads
    n_keep = c.vis_layers + 1 + c.vision_feature_layer \
        if c.vision_feature_layer < 0 else c.vision_feature_layer
    for i in range(n_keep):
        q = f"{p}layers.{i}."
        h = _ln(x, W, q + "layer_norm1")
        t = h.shape[1]

        def split(a):
            return a.reshape(n, t, heads, hd).transpose(1, 2)
        qs = split(_lin(h, W, q + "self_attn.q_proj")) / math.sqrt(hd)
        ks = split(_lin(h, W, q + "self_attn.k_proj"))
        vs = split(_lin(h, W, q + "self_attn.v_proj"))
        a = torch.softmax(qs @ ks.transpose(-1, -2), dim=-1) @ vs
        x = x + _lin(a.transpose(1, 2).reshape(n, t, d), W,
                     q + "self_attn.out_proj")
        h = _ln(x, W, q + "layer_norm2")
        h = _lin(h, W, q + "fc1")
        x = x + _lin(h * torch.sigmoid(1.702 * h), W, q + "fc2")
    feats = x[:, 1:] if c.drop_cls_token else x
    return _lin(F.gelu(_lin(feats, W, "mm_linear_1")), W, "mm_linear_2")


def image_features(W, c, image, dev) -> torch.Tensor:
    """The packed (N, hidden) features of a camera image."""
    tiles, hw = nx.preprocess_anyres(image, c.image_grid_pinpoints, c,
                                     normalize=True, device=dev)
    feats = tower(W, c, tiles)
    return nx.pack_anyres_features_torch(feats, hw, c.image_grid_pinpoints,
                                         c, W("image_newline"))


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (..., T, heads, hd); rotate-half convention."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                          dtype=torch.float32) / hd))
    ang = pos.to(torch.float32)[:, None] * freqs[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _attend(q, k, v, q_pos, k_pos, rep):
    """q (b, tq, H, hd), k/v (b, tk, KV, hd); causal by position."""
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    hd = q.shape[-1]
    out = []
    for lo in range(0, q.shape[1], 512):
        qc = q[:, lo:lo + 512].transpose(1, 2)
        s = qc @ k.transpose(1, 2).transpose(-1, -2) / math.sqrt(hd)
        mask = k_pos[None, :] <= q_pos[lo:lo + 512, None]
        s = s.masked_fill(~mask, float("-inf"))
        out.append((torch.softmax(s, -1) @ v.transpose(1, 2))
                   .transpose(1, 2))
    return torch.cat(out, dim=1)


def decoder_logits(W, c, prefix: torch.Tensor, suffix: torch.Tensor,
                   read_from: int) -> torch.Tensor:
    """Logits of the rows ``prefix`` (P, hidden) + ``suffix[r]`` (S,
    hidden) at the suffix positions from ``read_from`` on:
    (rows, S - read_from, vocab)."""
    dev = prefix.device
    b, s = suffix.shape[:2]
    p_len = prefix.shape[0]
    hd = c.head_dim
    rep = c.heads // c.kv_heads
    p_pos = torch.arange(p_len, device=dev)
    s_pos = torch.arange(p_len, p_len + s, device=dev)
    xp, xs = prefix[None], suffix
    for i in range(c.layers):
        q = f"layers.{i}."
        wq, wk, wv, wo = (W(f"{q}self_attn.{n}_proj.weight")
                          for n in ("q", "k", "v", "o"))
        g_in = W(q + "input_layernorm.weight")

        def qkv(x, pos):
            h = _rms(x, g_in, c.rms_eps)
            n, t = x.shape[:2]
            qq = _rope(F.linear(h, wq).reshape(n, t, c.heads, hd), pos,
                       c.rope_theta)
            kk = _rope(F.linear(h, wk).reshape(n, t, c.kv_heads, hd), pos,
                       c.rope_theta)
            vv = F.linear(h, wv).reshape(n, t, c.kv_heads, hd)
            return qq, kk, vv
        qp, kp, vp = qkv(xp, p_pos)
        qs, ks, vs = qkv(xs, s_pos)
        ap = _attend(qp, kp, vp, p_pos, p_pos, rep)
        kall = torch.cat([kp.expand(b, -1, -1, -1), ks], dim=1)
        vall = torch.cat([vp.expand(b, -1, -1, -1), vs], dim=1)
        a_s = _attend(qs, kall, vall, s_pos, torch.cat([p_pos, s_pos]), rep)
        xp = xp + F.linear(ap.reshape(1, p_len, -1), wo)
        xs = xs + F.linear(a_s.reshape(b, s, -1), wo)
        del wq, wk, wv, wo
        g_post = W(q + "post_attention_layernorm.weight")
        wg, wu, wd = (W(q + n + ".weight")
                      for n in ("gate_proj", "up_proj", "down_proj"))
        for name in ("xp", "xs"):
            x = xp if name == "xp" else xs
            h = _rms(x, g_post, c.rms_eps)
            x = x + F.linear(F.silu(F.linear(h, wg)) * F.linear(h, wu), wd)
            if name == "xp":
                xp = x
            else:
                xs = x
        del wg, wu, wd
    h = _rms(xs[:, read_from:], W("norm.weight"), c.rms_eps)
    return F.linear(h, W("lm_head.weight"))


def rerank_logits(W, c, rec: dict, dev) -> torch.Tensor:
    """(rows, steps, vocab) reference logits at the positions where the
    rerank's served tokens were read: the prompt's last position and
    each fed token after it."""
    n_img = int(rec["last"]["n_image_tokens"])
    feats = image_features(W, c, rec["image"], dev)
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


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """The reference's best logit less its logit of each token:
    (rows, steps)."""
    tok = torch.as_tensor(tokens, device=ref_logits.device,
                          dtype=torch.long)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tok[..., None])[..., 0]


def control_gaps(ref_logits, ctl_logits) -> torch.Tensor:
    """The gap of the token the control puts first at each position."""
    return token_gaps(ref_logits, ctl_logits.argmax(dim=-1))


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def judge_reranks(rerank, seed: int, limits: dict, facts: dict
                  ) -> List[Limit]:
    """The served tokens of a seeded sample of the window's reranks
    against the reference: the widest gap, beside the cell's limit."""
    _no_tf32()
    recs = [r for r in rerank.records if r.get("ran") and not r["failed"]]
    n = rerank.check_reranks
    rng = np.random.default_rng([seed, 4])
    picks = sorted(rng.choice(len(recs), min(n, len(recs)), replace=False)) \
        if recs else []
    W = served_weights(rerank.state, rerank.quantize)
    worst, count = 0.0, 0
    for j in picks:
        rec = recs[j]
        logits = rerank_logits(W, rerank.cfg, rec, rerank.dev)
        gaps = token_gaps(logits, rec["last"]["tokens"])
        worst = max(worst, float(gaps.max()))
        count += gaps.numel()
        del logits
    facts.update(reranks=float(len(recs)), reranks_judged=float(len(picks)),
                 served_tokens_judged=float(count))
    return [Limit("reranks_judged_none", float(not picks), 0.0),
            Limit("token_gap", worst, limits["token_gap"])]
