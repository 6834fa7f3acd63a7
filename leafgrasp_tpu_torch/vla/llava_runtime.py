"""Serving glue for the LLaVA stack: loader and candidate scorer. Port
of leafgrasp_tpu/vla/llava_runtime.py.

``LlavaTorchScorer`` is the VLAProcessor backend that evaluates grasp
candidates with a ``LlavaTorch`` model: the same prompt template and the
same parse contract as the JAX scorer, every candidate of a frame in one
left-padded batch. ``load_llava_from_hf`` loads a HuggingFace checkpoint
through transformers (the legacy path, for formats only transformers
parses); ``vla/checkpoint_io.load_llava_checkpoint`` reads a checkpoint
directory without it.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from leafgrasp_tpu_torch.utils.device import host_read, resolve_device
from leafgrasp_tpu_torch.utils.profiler import span
from leafgrasp_tpu_torch.vla.llava_next import (CLIP_IMAGE_MEAN,
                                                CLIP_IMAGE_STD,
                                                pack_anyres_features_torch,
                                                preprocess_anyres)
from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch, config_from_hf,
                                                 convert_hf_llava_state_dict,
                                                 greedy_generate_llava)
from leafgrasp_tpu_torch.vla.processor import build_prompt, parse_score

__all__ = ["LlavaTorchScorer", "CLIP_IMAGE_MEAN", "CLIP_IMAGE_STD",
           "preprocess_image", "load_llava_from_hf"]


def preprocess_image(image: np.ndarray, size: int) -> np.ndarray:
    """RGB image -> (1, size, size, 3) CLIP-normalized float32 (the
    single-tile path: nearest-neighbour resize)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.max() > 1.5:
        img = img / 255.0
    h, w = img.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    img = img[ys][:, xs]
    img = (img - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    return img[None]


def load_llava_from_hf(model_path: str, lora_rank: int = 0,
                       dtype: str = "float32", device=None):
    """Load a local HF LLaVA checkpoint VIA transformers (imported here;
    the legacy path, for checkpoints only transformers can parse, such as
    .bin pickles; ``load_llava_checkpoint`` reads the same directory
    without it). Floating-point weights are cast to ``dtype`` and placed
    on ``device`` (None means CUDA); with ``lora_rank > 0`` adapters are
    drawn as ``load_llava_checkpoint`` draws them. Returns (LlavaTorch,
    its state_dict, the HF tokenizer)."""
    import dataclasses
    from transformers import AutoTokenizer, LlavaForConditionalGeneration

    if not os.path.isdir(model_path):
        # a local directory only: never a hub id that transformers would
        # try to download
        raise FileNotFoundError(f"no checkpoint directory {model_path}")
    dev = resolve_device(device)
    cast = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    hf = LlavaForConditionalGeneration.from_pretrained(model_path,
                                                       local_files_only=True)
    cfg = dataclasses.replace(config_from_hf(hf.config), lora_rank=lora_rank)
    state = {k: v.detach().to(
                 device=dev, dtype=cast if v.is_floating_point() else v.dtype)
             for k, v in convert_hf_llava_state_dict(hf.state_dict(),
                                                     cfg).items()}
    del hf
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LlavaTorch.from_state(cfg, state, generator=gen)
    return model, model.state_dict(), AutoTokenizer.from_pretrained(
        model_path, local_files_only=True)


class LlavaTorchScorer:
    """VLAProcessor backend running the LlavaTorch stack on the model's
    device.

    tokenizer: any object with encode(text) -> ids and decode(ids) ->
    str. Image tokens are inserted as N copies of image_token_index
    before the prompt, the HF-processor convention.

    max_batch: cap on candidates per generate call (None = all at once).
    decode_mode: "scan" or "steps"; both take ``greedy_generate_llava``'s
    route: on a CUDA device the decode steps replay a CUDA graph over
    static caches, captured on the first batch of each shape; on the CPU
    and for a tensor-parallel model they run eagerly.
    decode_weight_layout: "default" only. The JAX package's "auto"
    relays the weights out for a compiled decode program; eager CUDA
    has nothing of the kind, so it raises ``ValueError``.
    anyres: the LLaVA-NeXT tiling path: tiles are encoded once per frame
    and shared by the candidates, packed on the device with unpadding
    and the newline row; needs ``cfg.image_grid_pinpoints``.

    ``last`` holds what the newest ``score`` call measured: token
    counts, the generated tokens, the prompt pass's route
    ``prefill_route`` of the newest batch ("shared" where its rows'
    image prefix ran once, else "full"), the decode's route
    ``decode_graph`` ("captured" where one of its batches captured a
    graph, else "replayed" or "eager"), for a grouped-query decoder the
    route of its steps' attention ``decode_attention`` ("kernel" or
    "plain", the newest batch's) and, on a CUDA device, the split into
    encode / prefill / decode milliseconds; for a decoder with experts
    ``moe_load``, each expert layer's busiest expert's routed pairs over
    the mean in a batch's prompt pass (computed on the device, fetched
    after the batch's tokens); ``scores``, the parsed scores, only once
    the call has returned them.
    """

    def __init__(self, model, tokenizer, max_new_tokens: int = 10,
                 max_batch: int | None = None, decode_mode: str = "scan",
                 decode_weight_layout: str = "default",
                 anyres: bool = False):
        if decode_mode not in ("scan", "steps"):
            raise ValueError(f"decode_mode {decode_mode!r}")
        if decode_weight_layout != "default":
            raise ValueError(
                f"decode_weight_layout={decode_weight_layout!r}: only "
                f"'default' exists here; 'auto' relays weights out for a "
                f"compiled XLA decode program and has no CUDA counterpart")
        if anyres and not model.cfg.image_grid_pinpoints:
            raise ValueError("anyres=True needs cfg.image_grid_pinpoints "
                             "(a LLaVA-NeXT / v1.6 config)")
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.max_batch = max_batch
        self.decode_mode = decode_mode
        self.decode_weight_layout = decode_weight_layout
        self.anyres = anyres
        self.last: dict = {}

    def _encode(self, prompt: str, n_image_tokens: int) -> list:
        ids = list(self.tokenizer.encode(prompt))
        if n_image_tokens:
            ids = [self.model.cfg.image_token_index] * n_image_tokens + ids
        return ids

    def _encode_image(self, image):
        """Shared per-frame image encode: (1, N, hidden) features + N.

        Single-tile path: one tower pass, N = num_patches. anyres: the
        frame goes to the device as bytes, is resized and tiled there,
        all tiles pass the tower as one batch and are packed with unpad
        and newline on the device."""
        model = self.model
        c = model.cfg
        if not self.anyres:
            px = torch.as_tensor(preprocess_image(image, c.image_size)) \
                .to(model.device)
            return model.vision_project(px), c.num_patches
        tiles, hw = preprocess_anyres(image, c.image_grid_pinpoints, c,
                                      normalize=True, device=model.device)
        packed = pack_anyres_features_torch(
            model.vision_project(tiles), hw, c.image_grid_pinpoints, c,
            model.image_newline)
        return packed[None], packed.shape[0]

    @torch.no_grad()
    def score(self, image, candidates: List[dict],
              instruction: str) -> List[float]:
        """Score every candidate in ONE batched generate (or in batches
        of ``max_batch``). The shared image is encoded once and, where
        every row holds just its tokens, its features go to the generate
        once for all the rows, which then computes the rows' image prefix
        once (``greedy_generate_llava``'s shared route). Masking keeps
        rows from attending across the batch or into pad slots, so
        batched scoring equals one-by-one scoring up to the order of
        floating-point sums."""
        dev = self.model.device
        timed = dev.type == "cuda"
        self.last = {"n_image_tokens": 0, "prompt_len": 0, "tokens": [],
                     "prefill_ms": 0.0, "decode_ms": 0.0}
        feats, n_img = None, 0
        if image is not None:
            if timed:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            feats, n_img = self._encode_image(image)  # (1, N, hidden)
            if timed:
                e1.record()
        rows = [self._encode(build_prompt(c, instruction), n_img)
                for c in candidates]
        step = self.max_batch or len(rows)
        out: List[float] = []
        for lo in range(0, len(rows), step):
            out.extend(self._score_batch(rows[lo:lo + step], feats))
        self.last["n_image_tokens"] = n_img
        if timed and image is not None:
            with span("device_wait"):
                e1.synchronize()
            self.last["encode_ms"] = e0.elapsed_time(e1)
        self.last["scores"] = list(out)
        return out

    def _score_batch(self, rows, feats) -> List[float]:
        dev = self.model.device
        b = len(rows)
        t = max(len(r) for r in rows)
        ids = np.zeros((b, t), np.int64)
        pad = np.zeros((b,), np.int32)
        for i, r in enumerate(rows):
            pad[i] = t - len(r)
            ids[i, pad[i]:] = r
        image = self.model.cfg.image_token_index
        if feats is not None and any(r.count(image) != feats.shape[1]
                                     for r in rows):
            # a text id that reads as the image token takes the next
            # feature of the flattened batch (the JAX scorer's splice):
            # the rows then share no prefix, and each gets the features
            feats = feats.expand(b, *feats.shape[1:])
        timings: dict = {}
        gen = greedy_generate_llava(
            self.model, torch.as_tensor(ids).to(dev), image_features=feats,
            max_new_tokens=self.max_new_tokens, pad_lens=pad,
            decode_mode=self.decode_mode, timings=timings)
        gen = host_read(gen)           # the one transfer of the batch
        load = timings.pop("moe_load", None)
        if load is not None:           # the tokens' read has synchronized
            self.last.setdefault("moe_load", []).append(load.tolist())
        # ``score`` resets ``last`` a call; a caller of this method alone
        # (the rerank stability tool) finds it filled as it goes
        self.last["prompt_len"] = t
        self.last.setdefault("tokens", []).extend(gen)
        self.last["prefill_route"] = timings.pop("prefill_route")
        attention = timings.pop("decode_attention", None)
        if attention is not None:
            self.last["decode_attention"] = attention
        route = timings.pop("decode_graph")
        if self.last.get("decode_graph") != "captured":
            self.last["decode_graph"] = route
        for key, val in timings.items():
            self.last[key] = self.last.get(key, 0.0) + val
        return [parse_score(self.tokenizer.decode(row)) for row in gen]
