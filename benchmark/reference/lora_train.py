"""The plain float32 reference of one LoRA training step of the LLaVA
(LLaVA-1.6 over Mistral-7B, ``llava_ref``'s tower, projector and
decoder) with rank-r adapters on the seven projections of every decoder
layer, written from the published LoRA (Hu et al. 2021, arXiv
2106.09685) as the program's ``LoRADense`` states it:

    y = x W^T + (alpha / r) (x A) B,   A (in, r),   B (r, out)

with the base frozen and B zero before the first step, so the step's
forward is the base model's and its gradient reaches B alone (A's is 0:
it passes through B). The loss is the mean next-token negative
log-likelihood over the answer tokens. The image enters as a single tile
(``num_patches`` features replacing the image tokens, the k-th image
token of the batch by the k-th feature row).

It reads the benchmark's drawn bf16 weights widened to float32 a layer
at a time, computes in float32 with TF32 off, runs the decoder forward
once keeping each layer's input, then goes back layer by layer:
recomputes the layer under autograd and takes the gradients of its
input and of its adapters from the gradient of its output. AdamW's first
step then moves each adapter, written out as Loshchilov and Hutter
(arXiv 1711.05101) state it at the settings the program's ``make_adamw``
takes (optax.adamw's betas 0.9 and 0.999, eps 1e-8, decoupled decay
1e-4, the cell's learning rate): at step 1 the bias-corrected moments
are g and g^2, so the change is -lr (g / (|g| + eps) + 1e-4 p). The
controls: ``quantize="fp8"`` rounds every matrix of the base to float8
e4m3 per output channel (``llava_ref.Weights``), ``tf32=True`` lets
float32 products and convolutions take TF32, ``adapter_dtype`` computes
the adapters' products in another type.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import llava_ref

ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj", "gate_proj", "up_proj", "down_proj")


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _layer(W, c, i, x, A, B, pos, scale, adapter_dtype):
    """Decoder layer ``i`` with its adapters (``A``, ``B``: by projection
    name) on x (b, t, hidden)."""
    p = f"layers.{i}."
    b, t = x.shape[:2]
    hd = c.head_dim

    def proj(name, h):
        y = F.linear(h, W(p + name + ".weight"))
        a, bb = A[p + name], B[p + name]
        dt = adapter_dtype
        delta = ((h.to(dt) @ a.to(dt)) @ bb.to(dt)).to(torch.float32)
        return y + scale * delta

    h = llava_ref._rms(x, W(p + "input_layernorm.weight"), c.rms_eps)
    q = llava_ref._rope(proj("self_attn.q_proj", h).reshape(b, t, c.heads,
                                                           hd), pos,
                        c.rope_theta)
    k = llava_ref._rope(proj("self_attn.k_proj", h).reshape(
        b, t, c.kv_heads, hd), pos, c.rope_theta)
    v = proj("self_attn.v_proj", h).reshape(b, t, c.kv_heads, hd)
    a = llava_ref._attend(q, k, v, pos, pos, c.heads // c.kv_heads)
    x = x + proj("self_attn.o_proj", a.reshape(b, t, -1))
    h = llava_ref._rms(x, W(p + "post_attention_layernorm.weight"),
                       c.rms_eps)
    return x + proj("down_proj", F.silu(proj("gate_proj", h))
                    * proj("up_proj", h))


def reference_step(state: Dict[str, torch.Tensor], c, lora_a: Dict,
                   traffic: dict, toks, lmask, pixels, tf32: bool = False,
                   adapter_dtype=torch.float32, quantize=None) -> dict:
    """{"loss": the step's loss, "grad": {adapter leaf: its gradient},
    "change": {adapter leaf: AdamW's first move of it}} of the batch
    ``toks`` (b, n) with loss mask ``lmask`` and normalized single-tile
    ``pixels`` (b, H, W, 3), under the drawn base ``state`` (adapter-free
    names) of config ``c`` and the adapters ``lora_a`` (by the program's
    leaf names; every B zero)."""
    scale = float(traffic["alpha"]) / float(traffic["rank"])
    with _matmul_precision(tf32):
        out = _step(llava_ref.Weights(state, quantize), c, lora_a, toks,
                    lmask, pixels, scale, adapter_dtype)
    lr = float(traffic["lr"])
    out["change"] = {
        k: adamw_first_change(lora_a[k].to(torch.float32) if k in lora_a
                              else torch.zeros_like(g), g, lr)
        for k, g in out["grad"].items()}
    return out


def adamw_first_change(p, g, lr: float) -> torch.Tensor:
    """AdamW's first step's change of a leaf ``p`` with gradient ``g``."""
    m = (1 - ADAM_B1) * g
    v = (1 - ADAM_B2) * g * g
    m_hat, v_hat = m / (1 - ADAM_B1), v / (1 - ADAM_B2)
    return -lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS) + WEIGHT_DECAY * p)


def _step(W, c, lora_a, toks, lmask, pixels, scale, adapter_dtype):
    dev = toks.device
    A = {k[:-len(".lora_a")]: v.to(torch.float32) for k, v in lora_a.items()}
    B = {k: torch.zeros((v.shape[1], W.state[k + ".weight"].shape[0]),
                        device=dev) for k, v in A.items()}
    ids = toks[:, :-1]
    b, t = ids.shape
    pos = torch.arange(t, device=dev)
    with torch.no_grad():
        feats = llava_ref.tower(W, c, pixels.to(torch.float32))
        x = W("embed_tokens.weight")[ids]
        is_img = ids == c.image_token_index
        x[is_img] = feats.reshape(-1, c.hidden)[:int(is_img.sum())]
        xs = [x]
        for i in range(c.layers):
            xs.append(_layer(W, c, i, xs[-1], A, B, pos, scale,
                             adapter_dtype))
    top = xs[-1].clone().requires_grad_(True)
    h = llava_ref._rms(top, W("norm.weight"), c.rms_eps)
    logp = torch.log_softmax(F.linear(h, W("lm_head.weight")), dim=-1)
    nll = -logp.gather(-1, toks[:, 1:, None])[..., 0]
    m = lmask[:, 1:].to(torch.float32)
    loss = (nll * m).sum() / m.sum().clamp(min=1.0)
    (g,) = torch.autograd.grad(loss, [top])
    del logp, nll, h
    grads = {}
    for i in reversed(range(c.layers)):
        names = [f"layers.{i}.{n}" for n in PROJ]
        a_i = {n: A[n].clone().requires_grad_(True) for n in names}
        b_i = {n: B[n].clone().requires_grad_(True) for n in names}
        x = xs[i].clone().requires_grad_(True)
        out = _layer(W, c, i, x, a_i, b_i, pos, scale, adapter_dtype)
        got = torch.autograd.grad(out, [x] + [a_i[n] for n in names]
                                  + [b_i[n] for n in names], g)
        g = got[0]
        for j, n in enumerate(names):
            grads[n + ".lora_a"] = got[1 + j]
            grads[n + ".lora_b"] = got[1 + len(names) + j]
        del out, got, x
    return {"loss": float(loss.detach()), "grad": grads}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the first loss's relative gap; the gradient
    Adam took at the first step, leaf by leaf: the norm of the
    difference over the larger of the reference leaf's norm and the
    median nonzero leaf's (A's leaves are 0 on both sides at the first
    step; a nonzero one on the program's side reads against the
    median), ``grad1_rel`` the worst leaf, ``grad_med_rel`` the median
    over the nonzero leaves; and each adapter's change over that step,
    as ``cnn_train`` compares it: the gap between the norms of the
    program's and the reference's change of a leaf over the larger of
    the reference's and the median leaf's, over the leaves with a
    nonzero gradient (A's change at step 1 is its decay alone, 5e-9 of
    it, which float32 rounds away), ``change_med_rel`` the median leaf
    and ``change_worst_rel`` the worst. Adam moves each element by about
    the learning rate whatever its gradient's size, so the change's norm
    reads the step's size and not its rounding: a state left unchanged
    reads 1, a learning rate off by a share reads that share."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref["grad"].items()}
    nonzero = sorted(v for v in norms.values() if v > 0)
    med = nonzero[len(nonzero) // 2] if nonzero else 1.0
    gaps = {}
    for k, r in ref["grad"].items():
        p = prog["grad"][k].to(r.device, torch.float64)
        d = float(torch.linalg.vector_norm(p - r.double()))
        gaps[k] = d / max(norms[k], med, 1e-30)
    live = sorted(gaps[k] for k in gaps if norms[k] > 0)
    moved = [k for k in ref["change"] if norms[k] > 0]
    ref_c = {k: float(torch.linalg.vector_norm(ref["change"][k].double()))
             for k in moved}
    vals = sorted(ref_c.values())
    med_c = vals[len(vals) // 2] if vals else 1.0
    change = sorted(
        abs(float(torch.linalg.vector_norm(prog["change"][k].double()))
            - ref_c[k]) / max(ref_c[k], med_c, 1e-30) for k in moved)
    return {"loss1_rel": abs(prog["loss"] - ref["loss"])
            / max(abs(ref["loss"]), 1e-30),
            "grad1_rel": max(gaps.values()),
            "grad_med_rel": live[len(live) // 2] if live else 0.0,
            "change_med_rel": change[len(change) // 2] if change else 1.0,
            "change_worst_rel": change[-1] if change else 1.0,
            "leaves": float(len(gaps))}
