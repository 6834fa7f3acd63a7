"""The LLaVA's LoRA fine-tuning step back to back: ``LlavaLoRATrainer``'s
loss over a LLaVA built with rank-``rank`` adapters on the seven
projections of every decoder layer (f32 adapters over the configuration's
bf16 weights, drawn on the card from the seed), ``make_adamw`` over the
adapters that ``set_trainable`` leaves trainable, and the step
``train_epochs`` takes (``zero_grad``, the loss, ``backward``,
``step``).

The mix's file (``traffic/<name>.json``, ``"loop": "train_lora"``) sets
the examples: ``pool`` camera images drawn from the seed (single tile,
``preprocess_image``'s path, ``num_patches`` image tokens a row), each
with ``text_tokens`` text ids after them, the last ``answer_tokens`` of
which carry the loss; a step takes ``batch`` of them, drawn from the
seed. Set-up drives the first step on the first batch and keeps its
loss, the gradients Adam took (``exp_avg`` over 1 - beta1) and each
adapter's change; the reference (``reference/lora_train.py``) computes
that step again, AdamW's update of the adapters included. The
window goes on with the same model and optimizer, reading nothing back
but the window's summed loss at its end; it ends with the first step
that is enqueued after ``--seconds``, and the card is synchronized
before its clock stops. In every run ``trace_steps`` more steps run
after it under the profiler: the card's busy time a step is this cell's
``train_device_ms``.
"""

from __future__ import annotations

import gc
import re
import time

import numpy as np
import torch

from benchmark.core import host
from benchmark.core.record import Limit, Run
from benchmark.core.trace import Tracer, span
from benchmark.models import llava_rerank
from benchmark.reference import lora_train

_LM_PROJ = re.compile(r"^(layers\.\d+\.(self_attn\.)?(q|k|v|o|gate|up|down)"
                      r"_proj)\.weight$")


def lora_model(config: dict, traffic: dict, seed: int, dev, overrides):
    """(model, the drawn base state under its adapter-free names, the
    plain config): the configuration's weights as ``llava_rerank`` draws
    them, the decoder's projections moved under ``base``, the adapters
    drawn as ``attach_lora`` draws them from a generator seeded
    ``seed + 1``."""
    import dataclasses
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    plain = llava_rerank.model_config(config, overrides)
    state = llava_rerank.draw_state(plain, seed, dev)
    cfg = dataclasses.replace(plain, lora_rank=int(traffic["rank"]),
                              lora_alpha=float(traffic["alpha"]))
    lora = {}
    for key, t in state.items():
        m = _LM_PROJ.match(key)
        lora[f"{m.group(1)}.base.weight" if m else key] = t
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    return LlavaTorch.from_state(cfg, lora, generator=gen), state, plain


def examples(cfg, traffic: dict, seed: int):
    """(toks (pool, num_patches + text_tokens) int64, the loss mask in
    that shape f32, images (pool, image_px, image_px, 3) uint8) on the
    host: ``num_patches`` image tokens, BOS, then text ids below the
    image token's, the last ``answer_tokens`` marked for the loss; all
    drawn from the seed. The model is fed every id but the last."""
    rng = np.random.default_rng([seed, 5])
    pool, n_text = int(traffic["pool"]), int(traffic["text_tokens"])
    n_img = cfg.num_patches
    limit = min(cfg.vocab_size, cfg.image_token_index)
    toks = np.zeros((pool, n_img + n_text), np.int64)
    toks[:, :n_img] = cfg.image_token_index
    toks[:, n_img] = 1
    toks[:, n_img + 1:] = rng.integers(3, limit, (pool, n_text - 1))
    lmask = np.zeros(toks.shape, np.float32)
    lmask[:, -int(traffic["answer_tokens"]):] = 1.0
    px = int(traffic["image_px"])
    images = rng.integers(0, 256, (pool, px, px, 3), dtype=np.uint8)
    return toks, lmask, images


class Setup:
    """The model, its trainer and optimizer, the examples on the card,
    and the first step's readings (``prog``)."""

    def __init__(self, cell, seed: int, dev, overrides: dict):
        from leafgrasp_tpu_torch.vla.llava_runtime import preprocess_image
        from leafgrasp_tpu_torch.vla.llava_trainer import LlavaLoRATrainer
        from leafgrasp_tpu_torch.vla.trainer import make_adamw, set_trainable
        config, traffic = cell.config, dict(cell.traffic, **overrides)
        self.config, self.traffic, self.dev = config, traffic, dev
        self.model, self.state, self.plain = lora_model(
            config, traffic, seed, dev, overrides)
        cfg = self.model.cfg
        tok = llava_rerank.FoldTok(min(cfg.vocab_size,
                                       cfg.image_token_index))
        self.trainer = LlavaLoRATrainer(
            self.model, tok, learning_rate=float(traffic["lr"]),
            max_len=cfg.num_patches + int(traffic["text_tokens"]),
            device=dev)
        self.params = set_trainable(self.model, False)
        self.optimizer = make_adamw(self.params, self.trainer.learning_rate)
        toks, lmask, images = examples(cfg, traffic, seed)
        self.toks = torch.as_tensor(toks, device=dev)
        self.lmask = torch.as_tensor(lmask, device=dev)
        self.pixels = torch.as_tensor(np.concatenate(
            [preprocess_image(im, cfg.image_size) for im in images]),
            device=dev)
        self.bs = int(traffic["batch"])
        # each step's rows distinct, drawn from the seed
        self.order = np.argsort(np.random.default_rng([seed, 6]).random(
            (1 << 12, toks.shape[0])), axis=1)[:, :self.bs]
        self.k = 0
        self.model.train()
        self.first = self.order[0]
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        # the adapters the first step starts from
        start = {n: p.detach().clone() for n, p in named}
        self.lora_a0 = {n: v for n, v in start.items()
                        if n.endswith(".lora_a")}
        loss = self.step()
        st = self.optimizer.state
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        self.prog = {
            "loss": float(loss),
            "grad": {n: (st[p]["exp_avg"] / (1 - beta1)).detach().clone()
                     if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                     for n, p in named},
            "change": {n: (p.detach() - start[n]) for n, p in named}}

    def batch(self):
        rows = self.order[self.k % self.order.shape[0]]
        self.k += 1
        idx = torch.as_tensor(rows, device=self.dev)
        return self.toks[idx], self.lmask[idx], self.pixels[idx]

    def step(self):
        opt = self.optimizer
        with span("train_step"):
            opt.zero_grad(set_to_none=True)
            loss = self.trainer.loss(*self.batch())
            loss.backward()
            opt.step()
        return loss.detach()

    def reference(self, **kw) -> dict:
        """The reference's first step on the first batch."""
        idx = torch.as_tensor(self.first, device=self.dev)
        return lora_train.reference_step(
            self.state, self.plain, self.lora_a0, self.traffic,
            self.toks[idx], self.lmask[idx], self.pixels[idx], **kw)

    def release(self):
        del self.model, self.optimizer, self.params, self.trainer


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        overrides: dict) -> Run:
    su = Setup(cell, seed, dev, overrides)
    traffic = su.traffic
    for _ in range(int(traffic["warmup_steps"])):
        su.step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()
    host0 = host.snapshot()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    steps, total = 0, None
    while True:
        loss = su.step()
        total = loss if total is None else total + loss
        steps += 1
        if time.perf_counter() >= deadline:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_win
    host_facts = host.window_facts(host0, host.snapshot())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    finite = bool(torch.isfinite(total).item())

    n_traced = int(traffic["trace_steps"])
    with Tracer() as tracer:
        for _ in range(n_traced):
            su.step()
    summary = tracer.reduce(n_traced)

    def check():
        su.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = su.reference()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = lora_train.compare(su.prog, ref)
        facts.update(loss_prog=su.prog["loss"], loss_ref=ref["loss"],
                     loss1_rel=got["loss1_rel"],
                     grad_med_rel=got["grad_med_rel"],
                     change_worst_rel=got["change_worst_rel"],
                     leaves=float(got["leaves"]))
        lim = cell.limits
        return [Limit("nonfinite_window_loss", float(not finite), 0.0),
                Limit("grad1_rel", got["grad1_rel"], lim["grad1_rel"]),
                Limit("change_med_rel", got["change_med_rel"],
                      lim["change_med_rel"])]

    facts = {"steps": float(steps), "window_s": window_s, **host_facts}
    return Run(kind="train", setup_s=setup_s, window_s=window_s,
               attempted=steps, failed=0, memory_peak_bytes=int(peak),
               steps=steps, trace=summary, work={}, check=check,
               facts=facts)
