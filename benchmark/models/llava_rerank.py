"""The LLaVA rerank configuration (``"model": "llava_rerank"``): the 7B
model drawn on the card from the seed, its scorer, the hybrid selector
the grasp service calls, what each rerank did, and the comparisons with
the plain references: the served tokens (``reference/llava_ref.py``)
and the re-picked leaf (``reference/rerank_pick.py``).

The serving loop finds this module by the configuration's ``model`` and
calls ``frame_config`` and ``build_rerank``. The weights are served in
the configuration's ``llava.dtype``; a ``quantize`` entry (``{"bits":
8}``) serves the decoder's projections and head in int8, as the program
quantizes them, and the reference rounds the same matrices its own
way."""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import work
from benchmark.core.record import Limit
from benchmark.reference import rerank_pick

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")

_GAIN = re.compile(r"(^|\.)(input_layernorm|post_attention_layernorm|norm|"
                   r"layer_norm1|layer_norm2|pre_layrnorm)\.weight$")
_GROUP = re.compile(r"^((vision_tower\.)?layers\.\d+)\.")


def frame_config(config: dict) -> dict:
    with open(os.path.join(CONFIG_DIR,
                           config["frame_config"] + ".json")) as fh:
        return json.load(fh)


def model_config(config: dict, overrides=None):
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    kw = dict(config["llava"])
    kw.update((overrides or {}).get("llava", {}))
    kw["image_grid_pinpoints"] = tuple(tuple(p) for p in
                                       kw["image_grid_pinpoints"])
    return LlavaTorchConfig(**kw)


def draw_state(cfg, seed: int, dev) -> Dict[str, torch.Tensor]:
    """Every parameter of ``LlavaTorch(cfg)`` in bf16 on ``dev``: one
    draw from a ``torch.Generator`` there for each layer of the tower and
    of the decoder and one for the rest, 0.02 * N(0, 1), the norm gains
    1 + 0.02 * N(0, 1). The tensors are views of those draws."""
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    template = LlavaTorch(cfg, device="meta",
                          param_dtype=torch.bfloat16).state_dict()
    groups: Dict[str, List] = {}
    for key, t in template.items():
        m = _GROUP.match(key)
        groups.setdefault(m.group(1) if m else "", []).append((key, t.shape))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = {}
    for _, items in groups.items():
        n = sum(int(np.prod(s)) for _, s in items)
        flat = torch.randn(n, generator=gen, device=dev,
                           dtype=torch.bfloat16).mul_(0.02)
        off = 0
        for key, shape in items:
            k = int(np.prod(shape))
            t = flat[off:off + k].view(shape)
            off += k
            if _GAIN.search(key):
                t.add_(1.0)
            state[key] = t
    return {k: state[k] for k in template}


class FoldTok:
    """A fixed-length stub tokenizer (after tools/_torch_bench.py
    ``FixedLenTok``, which keeps a prompt's first 59 bytes: the same for
    every candidate): BOS, then the prompt's bytes folded into ``n - 1``
    ids (byte i adds into slot i mod (n - 1)), so every candidate's row
    has one length and differs where its text differs. Ids stay below
    ``limit`` (the image token's id), so no text id reads as an image
    token. Records each encoded row."""

    def __init__(self, limit: int, n: int = 60):
        self.limit, self.n = limit, n
        self.rows: List[List[int]] = []

    def encode(self, text):
        slots = [0] * (self.n - 1)
        for i, b in enumerate(text.encode("utf-8")):
            j = i % (self.n - 1)
            slots[j] = (slots[j] * 131 + b + 1) % 1000003
        ids = [1] + [s % (self.limit - 3) + 3 for s in slots]
        self.rows.append(ids)
        return ids

    def decode(self, ids):
        return rerank_pick.hash_decimal(ids)


class _Scorer:
    """The scorer as the selector sees it, recording each call: the
    image, the rows, the scorer's ``last`` and whether it raised."""

    def __init__(self, inner, tok):
        self.inner, self.tok = inner, tok
        self.calls: List[dict] = []

    def score(self, image, candidates, instruction):
        self.tok.rows = []
        rec = {"image": image, "error": None}
        self.calls.append(rec)
        try:
            return self.inner.score(image, candidates, instruction)
        except Exception as exc:      # the selector falls back; we count
            rec["error"] = repr(exc)
            raise
        finally:
            rec["rows"] = list(self.tok.rows)
            rec["last"] = dict(self.inner.last)


def program_model(cfg, state, quantize):
    """``LlavaTorch`` on the drawn state: as drawn, or with the
    decoder's projections and head quantized by the program
    (``quantize_llava_variables``) at ``quantize["bits"]``."""
    import dataclasses
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    if not quantize:
        return LlavaTorch.from_state(cfg, state)
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_variables
    bits = int(quantize["bits"])
    if bits != 8:
        raise ValueError(f"quantize {quantize}: the reference rounds to "
                         f"8 bits only")
    return LlavaTorch.from_state(
        dataclasses.replace(cfg, quantized=True, quant_bits=bits),
        quantize_llava_variables(state, bits=bits))


def build_rerank(config: dict, seed: int, dev, overrides, traffic):
    return Rerank(config, seed, dev, overrides, traffic)


class Rerank:
    def __init__(self, config: dict, seed: int, dev, overrides=None,
                 traffic=None):
        from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
        from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
        from leafgrasp_tpu_torch.vla.processor import VLAProcessor
        self.config, self.dev = config, dev
        self.check_reranks = int((traffic or {}).get("check_reranks", 6))
        self.num_candidates = int(
            frame_config(config)["pipeline"]["vla"]["num_candidates"])
        self.quantize = config.get("quantize")
        self.cfg = model_config(config, overrides)
        self.state = draw_state(self.cfg, seed, dev)
        self.model = program_model(self.cfg, self.state, self.quantize)
        sc = config["scorer"]
        self.tok = FoldTok(min(self.cfg.vocab_size,
                               self.cfg.image_token_index),
                           int(sc["text_tokens"]))
        self.scorer = _Scorer(LlavaTorchScorer(
            self.model, self.tok, max_new_tokens=int(sc["max_new_tokens"]),
            anyres=bool(sc["anyres"])), self.tok)
        self.selector = HybridGraspSelector(VLAProcessor(self.scorer))
        self.records: List[dict] = []
        self._counts = None

    # -- the window's bookkeeping --
    def take(self):
        """What this frame's rerank did: None if it ran none; a record,
        with ``failed`` set, if it raised."""
        calls, self.scorer.calls = self.scorer.calls, []
        if not calls:
            return {"ran": False}
        rec = calls[-1]
        rec["ran"] = True
        rec["failed"] = rec["error"] is not None or \
            len(rec["last"].get("tokens", [])) != len(rec["rows"])
        if self._counts is not None and not rec["failed"]:
            self._count(rec)
        self.records.append(rec)
        return rec

    def count_work(self, counts: dict):
        self._counts = counts
        counts.setdefault("rerank_flop", 0.0)
        counts.setdefault("attn_flop", 0.0)
        counts.setdefault("attn_bytes", 0.0)

    def stop_counting(self):
        self._counts = None

    def _count(self, rec):
        c, counts = self.cfg, self._counts
        n_img = int(rec["last"]["n_image_tokens"])
        prompts = [[c.image_token_index] * n_img + r for r in rec["rows"]]
        served = rec["last"]["tokens"]
        fed = [p + list(s[:-1]) for p, s in zip(prompts, served)]
        hd = c.head_dim
        counts["rerank_flop"] += rerank_flop(c, prompts, fed,
                                             n_tiles(c, rec["image"]))
        pairs = work.shared_prefix_pairs(prompts)
        counts["attn_flop"] += work.attention_flop(pairs, c.heads, hd,
                                                   c.layers)
        counts["attn_bytes"] += work.attention_bytes(
            work.distinct_tokens(prompts), c.heads, c.kv_heads, hd,
            c.layers)

    def release(self):
        del self.model, self.scorer, self.selector

    def reference_choice(self, ref, rec) -> Dict[str, int]:
        """What the reference makes of a frame's rerank ``rec`` on the
        reference frame ``ref``: the leaf it re-picks from the served
        tokens, and whether the scorer's rows are the reference's
        candidates' prompts (1 where they are not)."""
        cands = rerank_pick.candidates(ref.leaf_selection,
                                       self.num_candidates)
        tok = FoldTok(self.tok.limit, self.tok.n)
        rows = [tok.encode(rerank_pick.prompt(c)) for c in cands]
        leaf = rerank_pick.choose(cands, rec["last"]["tokens"]) \
            if cands and len(rows) == len(rec["last"]["tokens"]) else -1
        return {"leaf": leaf, "rows_differ": int(rows != rec["rows"])}

    def check(self, seed: int, limits: dict, facts: dict) -> List[Limit]:
        from benchmark.reference import llava_ref
        return llava_ref.judge_reranks(self, seed, limits, facts)


def n_tiles(c, image) -> int:
    """Tiles of the anyres path for ``image``: the base and the grid."""
    from benchmark.reference.llava_next_ref import anyres_grid_shape
    gw, gh = anyres_grid_shape(np.asarray(image).shape[:2],
                               c.image_grid_pinpoints, c.image_size)
    return 1 + gw * gh


def decoder_token_flop(c) -> float:
    """Dense products of one token through the decoder's layers."""
    hd = c.head_dim
    attn = c.hidden * (c.heads * hd * 2 + c.kv_heads * hd * 2)
    mlp = 3 * c.hidden * c.intermediate
    return 2.0 * c.layers * (attn + mlp)


def tower_flop(c, n_tiles: int) -> float:
    """The tower's layers that run (up to the feature layer), its patch
    embedding, and the projector, over ``n_tiles`` tiles."""
    t = (c.image_size // c.patch_size) ** 2 + 1
    d, f = c.vis_hidden, c.vis_intermediate
    n_keep = c.vis_layers + 1 + c.vision_feature_layer \
        if c.vision_feature_layer < 0 else c.vision_feature_layer
    layer = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
    embed = 2.0 * (t - 1) * 3 * c.patch_size ** 2 * d
    proj = 2.0 * (t - 1) * (d * c.hidden + c.hidden * c.hidden)
    return n_tiles * (n_keep * layer + embed + proj)


def rerank_flop(c, prompts, fed, n_tiles: int) -> float:
    """The products a rerank needs: the tower over its tiles, every
    distinct token of the rows fed to the decoder once (a prefix the rows
    share once), ``lm_head`` where a token is read, and the causal
    attention of those tokens."""
    distinct = work.distinct_tokens(fed)
    reads = sum(len(f) - len(p) + 1 for p, f in zip(prompts, fed))
    pairs = work.shared_prefix_pairs(fed)
    return (tower_flop(c, n_tiles) + distinct * decoder_token_flop(c)
            + reads * 2.0 * c.hidden * c.vocab_size
            + work.attention_flop(pairs, c.heads, c.head_dim, c.layers))
