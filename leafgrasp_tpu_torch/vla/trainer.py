"""VLA LoRA fine-tuning of the TinyVLA: the port of
leafgrasp_tpu/vla/trainer.py.

Candidate rankings become per-candidate target scores ``1 - position /
len``; the LM is trained to emit the target decimal after the evaluation
prompt, with the loss on the answer and EOS tokens only (the vision
prefix rows stripped); evaluation reports top-1 ranking accuracy and the
Spearman correlation through ``TinyVLAScorer``.

The optimizer is optax's ``adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay 1e-4) over the trainable leaves, and the frozen
leaves take no step and no decay (``multi_transform`` with
``set_to_zero``): they get ``requires_grad=False`` and stay out of the
optimizer. Batching is the JAX trainer's: the example order is shuffled
with ``np.random.default_rng(seed)`` each epoch and the remainder that
does not fill a batch is dropped, so at ``lora_dropout=0`` the batches,
and the loss history, follow JAX's. LoRA dropout applies in training, its
masks from a ``torch.Generator`` seeded with ``seed + 1`` (JAX draws its
own bits from ``PRNGKey(seed + 1)``; the masks differ, their law does
not).

Adapters and the pretrained base are saved in the JAX package's ``.npz``
format (flat ``"a/b/c"`` Flax keys) with the same
``.adapter_config.json``, so either package loads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from leafgrasp_tpu_torch.utils.device import host_read, resolve_device
from leafgrasp_tpu_torch.vla.convert import (flax_to_torch_tiny_vla,
                                             torch_to_flax_tiny_vla)
from leafgrasp_tpu_torch.vla.lm import (VLAModelConfig, ByteTokenizer,
                                        init_vla)
from leafgrasp_tpu_torch.vla.lora import (extract_lora_params,
                                          graft_base_params, is_lora_key,
                                          merge_lora_params,
                                          set_dropout_generator)
from leafgrasp_tpu_torch.vla.processor import build_prompt

__all__ = ["VLATrainer", "make_synthetic_vla_dataset",
           "spearman_correlation", "ranking_to_targets"]

INSTRUCTION = "Select the best leaf for grasping"
TARGET_MODULES = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj"]
WEIGHT_DECAY = 1e-4                 # optax.adamw's default


def spearman_correlation(a, b) -> float:
    ar = np.argsort(np.argsort(a))
    br = np.argsort(np.argsort(b))
    if np.std(ar) == 0 or np.std(br) == 0:
        return 0.0
    return float(np.corrcoef(ar, br)[0, 1])


def make_synthetic_vla_dataset(num_samples: int = 50, seed: int = 0,
                               num_candidates: int = 5,
                               image_size: int = 64) -> List[Dict]:
    """Synthetic ellipse-leaf scenes with a weighted ground-truth ranking
    (weights 0.35 / 0.35 / 0.3 for clutter / distance / visibility); the
    same numpy draws as the JAX package, so the same arrays."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(num_samples):
        img = rng.uniform(0.1, 0.3, (image_size, image_size, 3)) \
            .astype(np.float32)
        candidates = []
        margin = max(2, min(8, image_size // 4))
        for _ in range(num_candidates):
            cx, cy = rng.integers(margin, image_size - margin, 2)
            clutter = float(rng.uniform(0.2, 1.0))
            distance = float(rng.uniform(0.2, 1.0))
            visibility = float(rng.uniform(0.2, 1.0))
            gt = 0.35 * clutter + 0.35 * distance + 0.3 * visibility
            img[max(cy - 4, 0):cy + 4, max(cx - 4, 0):cx + 4, 1] += 0.4
            candidates.append(dict(
                x=int(cx), y=int(cy), clutter_score=clutter,
                distance_score=distance, visibility_score=visibility,
                geometric_score=gt))
        ranking = list(np.argsort([-c["geometric_score"]
                                   for c in candidates]))
        samples.append(dict(image=np.clip(img, 0, 1),
                            candidates=candidates,
                            ranking=[int(r) for r in ranking]))
    return samples


def ranking_to_targets(ranking: List[int]) -> Dict[int, float]:
    """candidate index -> target score ``1 - pos / len``."""
    n = len(ranking)
    return {int(idx): 1.0 - pos / n for pos, idx in enumerate(ranking)}


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    h, w = img.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return img[ys][:, xs]


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               lmask: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over the positions ``lmask`` marks (the
    softmax in the logits' type, the sum in f32)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return torch.sum(nll.to(torch.float32) * lmask) \
        / torch.clamp(torch.sum(lmask), min=1.0)


def make_adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """optax.adamw(learning_rate): decoupled decay 1e-4 on the leaves it
    is given."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WEIGHT_DECAY)


def set_trainable(model: torch.nn.Module, full: bool) -> list:
    """Mark the adapter leaves (every leaf if ``full``) as trainable and
    freeze the rest; returns the trainable parameters in order."""
    params = []
    for name, p in model.named_parameters():
        train = full or is_lora_key(name)
        p.requires_grad_(train)
        if train:
            params.append(p)
    return params


def epoch_mean(losses: list) -> float:
    """Mean of an epoch's step losses (0-dim tensors), one host read."""
    if not losses:
        return float("nan")
    return float(np.mean(host_read(torch.stack(losses).float())))


def train_epochs(model: torch.nn.Module, opt: torch.optim.Optimizer,
                 examples: list, make_batch, loss_fn, epochs: int,
                 batch_size: int, seed: int, log_fn=None) -> Dict:
    """The JAX trainers' loop: the example order shuffled with
    ``np.random.default_rng(seed)`` each epoch, the remainder that does
    not fill a batch dropped, one step a batch of
    ``loss_fn(*make_batch(batch))``; one host read an epoch. Leaves the
    model in eval mode."""
    model.train()
    np_rng = np.random.default_rng(seed)
    order = np.arange(len(examples))
    history = []
    for epoch in range(epochs):
        np_rng.shuffle(order)
        losses = []
        for s0 in range(0, len(order) - batch_size + 1, batch_size):
            batch = make_batch([examples[i]
                                for i in order[s0:s0 + batch_size]])
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(*batch)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        ep_loss = epoch_mean(losses)
        history.append(ep_loss)
        if log_fn:
            log_fn(epoch=epoch, loss=ep_loss)
    model.eval()
    return {"loss_history": history, "final_loss": history[-1]}


def rank_metrics(scorer, samples: List[Dict]) -> Dict:
    """Top-1 ranking accuracy and mean Spearman of ``scorer``'s scores
    against the samples' ground truth."""
    top1, spear = [], []
    for s in samples:
        scores = scorer.score(s["image"], s["candidates"], INSTRUCTION)
        gt = [c["geometric_score"] for c in s["candidates"]]
        top1.append(int(np.argmax(scores)) == int(np.argmax(gt)))
        spear.append(spearman_correlation(scores, gt))
    return {"top1_accuracy": float(np.mean(top1)),
            "spearman": float(np.mean(spear))}


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> str:
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.expanduser(path)) as data:
        return {k: data[k] for k in data.files}


@dataclasses.dataclass
class VLATrainer:
    """LoRA (or, through ``pretrain``, full) training of a TinyVLA.
    ``device=None`` means CUDA and raises without it."""

    cfg: VLAModelConfig = VLAModelConfig(lora_rank=8, lora_alpha=32.0,
                                         lora_dropout=0.1)
    learning_rate: float = 5e-5
    seed: int = 0
    max_prompt_len: int = 512
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.tokenizer = ByteTokenizer()
        self.model = init_vla(self.seed, self.cfg, device=self.device)

    # ------------------------------------------------------------ data --

    def _example(self, sample: Dict, cand_idx: int, target: float):
        prompt = build_prompt(sample["candidates"][cand_idx], INSTRUCTION)
        answer = f"{target:.2f}"
        p_ids = self.tokenizer.encode(prompt)
        a_ids = self.tokenizer.encode(answer, add_bos=False)
        ids = np.concatenate([p_ids, a_ids,
                              [self.tokenizer.eos]]).astype(np.int32)
        # loss only on the answer + EOS tokens
        loss_mask = np.zeros(len(ids), np.float32)
        loss_mask[len(p_ids):] = 1.0
        return ids, loss_mask, sample["image"]

    def _pad_batch(self, examples, pad_to: int):
        b = len(examples)
        patch = self.cfg.vision_patch
        toks = np.zeros((b, pad_to), np.int64)
        mask = np.zeros((b, pad_to), np.float32)
        imgs = np.zeros((b, patch, patch, 3), np.float32)
        for i, (ids, lm, img) in enumerate(examples):
            if len(ids) > pad_to:
                # keep the answer: truncate the prompt from the LEFT
                ids, lm = ids[-pad_to:], lm[-pad_to:]
            n = len(ids)
            toks[i, :n] = ids
            mask[i, :n] = lm
            imgs[i] = _resize(img, patch)
        return tuple(torch.as_tensor(a).to(self.device)
                     for a in (toks, mask, imgs))

    # ----------------------------------------------------------- train --

    def _loss(self, toks, lmask, imgs):
        logits, _ = self.model(toks[:, :-1], image=imgs)
        # strip the vision prefix rows; next-token prediction
        logits = logits[:, self.cfg.vision_tokens:, :]
        return masked_nll(logits, toks[:, 1:], lmask[:, 1:])

    def fine_tune(self, samples: List[Dict], epochs: int = 1,
                  batch_size: int = 4, log_fn=None) -> Dict:
        """LoRA-adapter fine-tuning (frozen base)."""
        return self._train(samples, epochs, batch_size, log_fn,
                           full_params=False)

    def pretrain(self, samples: List[Dict], epochs: int = 20,
                 batch_size: int = 32, learning_rate: float = 1e-3,
                 log_fn=None) -> Dict:
        """Full-parameter pretraining of the base LM on the scoring
        corpus, to graft into each LoRA experiment
        (``load_pretrained_base`` / ``lora.graft_base_params``): a random
        frozen base leaves LoRA only the answer format to learn."""
        return self._train(samples, epochs, batch_size, log_fn,
                           full_params=True, learning_rate=learning_rate)

    def _train(self, samples: List[Dict], epochs: int, batch_size: int,
               log_fn, full_params: bool,
               learning_rate: float | None = None) -> Dict:
        examples = []
        for s in samples:
            for idx, tgt in ranking_to_targets(s["ranking"]).items():
                examples.append(self._example(s, idx, tgt))
        pad_to = min(self.max_prompt_len,
                     max(len(e[0]) for e in examples))
        lr = self.learning_rate if learning_rate is None else learning_rate
        model = self.model
        opt = make_adamw(set_trainable(model, full_params), lr)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        set_dropout_generator(model, gen)
        out = train_epochs(model, opt, examples,
                           lambda batch: self._pad_batch(batch, pad_to),
                           self._loss, epochs, batch_size, self.seed, log_fn)
        set_dropout_generator(model, None)
        return out

    # ------------------------------------------------------------ eval --

    def evaluate(self, samples: List[Dict]) -> Dict:
        """Top-1 ranking accuracy and mean Spearman against the ground
        truth, with the trained model behind ``TinyVLAScorer``."""
        from leafgrasp_tpu_torch.vla.processor import TinyVLAScorer
        return rank_metrics(TinyVLAScorer(self.model.eval()), samples)

    # ------------------------------------------------------- adapters --

    def save_adapter(self, path: str):
        lora = extract_lora_params(self.model.state_dict())
        path = save_npz(path, torch_to_flax_tiny_vla(lora))
        cfg = {"r": self.cfg.lora_rank, "lora_alpha": self.cfg.lora_alpha,
               "lora_dropout": self.cfg.lora_dropout,
               "target_modules": TARGET_MODULES}
        with open(path + ".adapter_config.json", "w") as f:
            json.dump(cfg, f, indent=2)

    def load_adapter(self, path: str):
        adapter = flax_to_torch_tiny_vla(load_npz(path))
        self.model.load_state_dict(merge_lora_params(
            self.model.state_dict(), adapter))

    def load_pretrained_base(self, path: str):
        """Graft a saved pretrained base (``pretrained_base.npz`` of
        ``run_vla_sweep``, from either package) into this trainer's
        model; ``load_adapter`` then overlays an experiment's deltas."""
        plain = flax_to_torch_tiny_vla(load_npz(path))
        self.model.load_state_dict(graft_base_params(
            self.model.state_dict(), plain))
