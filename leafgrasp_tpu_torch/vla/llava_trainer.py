"""LoRA fine-tuning of the LLaVA stack: the port of
leafgrasp_tpu/vla/llava_trainer.py.

The same pipeline as ``VLATrainer`` against ``LlavaTorch``: targets from
the ranking, ``num_patches`` image tokens before the prompt, the loss on
the answer tokens only, the frozen base (vision tower included) with
``requires_grad=False`` and out of the optimizer (optax's
``set_to_zero``), optax's ``adamw`` on the adapters (on everything with
``train_full``), and adapters saved in the same ``.npz`` format and
``.adapter_config.json``.

As in the JAX trainer, the adapters run without dropout: ``LlavaJax``
never passes ``train`` to its ``LoRADense`` layers, so its dropout rng
draws nothing, and ``LlavaTorch`` builds its adapters with dropout off
in training mode. The model's prompt pass takes the route its config
names; on the ``"flash"`` route the gradient goes through the kernels'
autograd Function (``kernels/flash_prefill``).

One difference, where the JAX trainer fails: with ``max_len <=
num_patches`` the JAX ``_example`` keeps the whole sequence
(``ids[-0:]``) and ``_pad_batch`` raises a numpy broadcast error; here
``_example`` raises a ``ValueError`` that names both numbers.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from leafgrasp_tpu_torch.utils.device import resolve_device
from leafgrasp_tpu_torch.vla.convert import (flax_to_torch_llava,
                                             torch_to_flax_llava_adapter)
from leafgrasp_tpu_torch.vla.llava_runtime import preprocess_image
from leafgrasp_tpu_torch.vla.lora import (extract_lora_params,
                                          merge_lora_params)
from leafgrasp_tpu_torch.vla.processor import build_prompt
from leafgrasp_tpu_torch.vla.trainer import (INSTRUCTION, TARGET_MODULES,
                                             load_npz, make_adamw,
                                             masked_nll, rank_metrics,
                                             ranking_to_targets, save_npz,
                                             set_trainable, train_epochs)

__all__ = ["LlavaLoRATrainer"]


class LlavaLoRATrainer:
    """Fine-tune the LoRA adapters of a ``LlavaTorch`` model in place.

    The model must be built with ``cfg.lora_rank > 0`` and hold its
    adapters (``llava_torch.attach_lora``), unless ``train_full``, which
    updates every parameter (the pretraining mode). tokenizer:
    ``encode(text) -> ids`` (and ``decode`` for ``evaluate``).
    ``device=None`` means CUDA and raises without it; the model must lie
    on that device."""

    def __init__(self, model, tokenizer, learning_rate: float = 5e-5,
                 seed: int = 0, max_len: int = 576,
                 train_full: bool = False, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the "
                             f"trainer was asked for {self.device}")
        if not train_full and model.cfg.lora_rank <= 0:
            raise ValueError("build the model with lora_rank > 0 (or "
                             "train_full=True)")
        self.train_full = train_full
        self.model = model
        self.tokenizer = tokenizer
        self.learning_rate = learning_rate
        self.seed = seed
        self.max_len = max_len

    # ------------------------------------------------------------- data --

    def _example(self, sample: Dict, cand_idx: int, target: float):
        c = self.model.cfg
        prompt = build_prompt(sample["candidates"][cand_idx], INSTRUCTION)
        answer = f"{target:.2f}"
        p_ids = [c.image_token_index] * c.num_patches \
            + list(self.tokenizer.encode(prompt))
        a_ids = list(self.tokenizer.encode(answer))
        ids = np.asarray(p_ids + a_ids, np.int32)
        loss_mask = np.zeros(len(ids), np.float32)
        loss_mask[len(p_ids):] = 1.0
        if len(ids) > self.max_len:      # keep the answer: trim the prompt
            keep = self.max_len - c.num_patches
            if keep <= 0:
                raise ValueError(
                    f"max_len {self.max_len} leaves no room for text after "
                    f"the {c.num_patches} image tokens (num_patches); an "
                    f"example here has {len(ids)} ids: pass max_len > "
                    f"num_patches")
            ids = np.concatenate([ids[:c.num_patches], ids[-keep:]])
            loss_mask = np.concatenate([loss_mask[:c.num_patches],
                                        loss_mask[-keep:]])
        return ids, loss_mask, sample["image"]

    def _pad_batch(self, examples, pad_to: int):
        c = self.model.cfg
        n = len(examples)
        toks = np.zeros((n, pad_to), np.int64)
        lmask = np.zeros((n, pad_to), np.float32)
        imgs = np.zeros((n, c.image_size, c.image_size, 3), np.float32)
        for i, (ids, lm, img) in enumerate(examples):
            toks[i, :len(ids)] = ids
            lmask[i, :len(lm)] = lm
            imgs[i] = preprocess_image(img, c.image_size)[0]
        return tuple(torch.as_tensor(a).to(self.device)
                     for a in (toks, lmask, imgs))

    # ------------------------------------------------------------ train --

    def loss(self, toks, lmask, imgs) -> torch.Tensor:
        """The training loss of a padded batch (``_pad_batch``'s)."""
        logits, _ = self.model(toks[:, :-1], pixel_values=imgs)
        return masked_nll(logits, toks[:, 1:], lmask[:, 1:])

    def examples(self, samples: List[Dict]) -> list:
        return [self._example(s, idx, tgt) for s in samples
                for idx, tgt in ranking_to_targets(s["ranking"]).items()]

    def fine_tune(self, samples: List[Dict], epochs: int = 1,
                  batch_size: int = 2, log_fn=None) -> Dict:
        """Train for ``epochs`` over the samples' examples (shuffled with
        ``np.random.default_rng(seed)`` each epoch, the remainder that
        does not fill a batch dropped); one host read an epoch."""
        examples = self.examples(samples)
        pad_to = min(self.max_len, max(len(e[0]) for e in examples) + 1)
        opt = make_adamw(set_trainable(self.model, self.train_full),
                         self.learning_rate)
        return train_epochs(
            self.model, opt, examples,
            lambda batch: self._pad_batch(batch, pad_to), self.loss, epochs,
            batch_size, self.seed, log_fn)

    # ------------------------------------------------------------- eval --

    def evaluate(self, samples: List[Dict]) -> Dict:
        """Top-1 ranking accuracy and mean Spearman against the ground
        truth, through ``LlavaTorchScorer``."""
        from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
        return rank_metrics(
            LlavaTorchScorer(self.model.eval(), self.tokenizer), samples)

    # --------------------------------------------------------- adapters --

    def save_adapter(self, path: str):
        lora = extract_lora_params(self.model.state_dict())
        path = save_npz(path, torch_to_flax_llava_adapter(lora))
        c = self.model.cfg
        with open(path + ".adapter_config.json", "w") as f:
            json.dump({"r": c.lora_rank, "lora_alpha": c.lora_alpha,
                       "lora_dropout": c.lora_dropout,
                       "base_model": "llava-jax",
                       "target_modules": TARGET_MODULES}, f, indent=2)

    def load_adapter(self, path: str):
        adapter = flax_to_torch_llava(load_npz(path))
        self.model.load_state_dict(merge_lora_params(
            self.model.state_dict(), adapter))
