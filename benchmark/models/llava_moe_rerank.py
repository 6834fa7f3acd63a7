"""The LLaVA-NeXT rerank over DeepSeek-V3's decoder (``"model":
"llava_moe_rerank"``): the tower and projector of LLaVA-NeXT in front of
Moonlight-16B-A3B's decoder (latent attention, routed and shared
experts), drawn on the card from the seed, served by the same scorer,
selector and service as ``llava_rerank``; the served tokens are judged
against ``reference/llava_moe_ref.py``, the re-picked leaf against
``reference/rerank_pick.py``.

The configuration file holds the decoder's published keys at its top
level (DeepSeek's names) and the tower, the image token and the serving
settings under ``llava``. Every parameter is drawn as ``llava_rerank``
draws them (0.02 * N(0, 1), the norm gains 1 + 0.02 * N(0, 1)), but for
the routers, which are set as trained ones are, and for
``kv_a_layernorm``'s gains. Drawn weights send nearly every token of an
image to the same experts (the tokens share a large common part, which
the router reads as a per-expert offset), and DeepSeek-V3's
auxiliary-loss-free balancing (``noaux_tc``) trains each correction bias
to even the experts' load out. A router so balanced on drawn weights
reads what is left, the tokens' small own parts, against the common
part's rounding, so bf16 would decide most choices; a trained router
reads the directions in which its tokens differ. So set-up runs the
plain reference's float32 pass over the rerank rows of
``router_calibration_frames`` frames of the traffic's kind (drawn from a
seed of their own, not frames the window serves), and at each expert
layer draws the gate within the ``router_subspace`` directions in which
that layer's inputs spread the most and balances the correction bias on
those inputs until their load is even; on the frames served the busiest
expert of a layer then takes a few times the mean share, as trained
routers are uneven on one image's tokens. No program code runs in it.
``kv_a_layernorm``'s gains are exp(``kv_a_layernorm_gain_spread`` *
N(0, 1)): at 1 + 0.02 * N(0, 1) the norm is nearly the identity on
drawn weights (the drawn latent's RMS is 0.905 on every token).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import work_moe
from benchmark.models import grasp_service as grasp
from benchmark.models import llava_rerank
from benchmark.models.llava_rerank import FoldTok, frame_config

# the decoder's published keys, by LlavaTorchConfig field
DECODER_KEYS = {
    "hidden": "hidden_size", "intermediate": "intermediate_size",
    "layers": "num_hidden_layers", "heads": "num_attention_heads",
    "kv_heads": "num_key_value_heads", "vocab_size": "vocab_size",
    "rope_theta": "rope_theta", "rms_eps": "rms_norm_eps",
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "n_routed_experts": "n_routed_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "n_shared_experts": "n_shared_experts",
    "moe_intermediate_size": "moe_intermediate_size",
    "first_k_dense_replace": "first_k_dense_replace",
    "routed_scaling_factor": "routed_scaling_factor",
    "norm_topk_prob": "norm_topk_prob",
}

# the balancing rule: steps of the bias against each expert's load over
# the mean, at a rate falling geometrically from BALANCE_RATE by
# BALANCE_FALL over BALANCE_STEPS
BALANCE_RATE, BALANCE_FALL, BALANCE_STEPS = 0.02, 0.01, 200

_GAIN = re.compile(r"(^|\.)(input_layernorm|post_attention_layernorm|norm|"
                   r"kv_a_layernorm|layer_norm1|layer_norm2|pre_layrnorm)"
                   r"\.weight$")
_BIAS = re.compile(r"\.e_score_correction_bias$")
_GROUP = re.compile(r"^((vision_tower\.)?layers\.\d+)\.")


def check_published(config: dict) -> None:
    """Raise for a published setting the decoder does not serve."""
    want = {"model_type": "deepseek_v3", "q_lora_rank": None, "n_group": 1,
            "topk_group": 1, "scoring_func": "sigmoid",
            "topk_method": "noaux_tc", "hidden_act": "silu",
            "moe_layer_freq": 1, "attention_bias": False,
            "tie_word_embeddings": False}
    bad = {k: config.get(k) for k, v in want.items() if config.get(k) != v}
    if bad:
        raise ValueError(f"deepseek_v3 settings not served: {bad}")


def model_config(config: dict, overrides=None):
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    check_published(config)
    kw = {f: config[k] for f, k in DECODER_KEYS.items()}
    kw.update(config["llava"])
    kw.update((overrides or {}).get("llava", {}))
    kw["image_grid_pinpoints"] = tuple(tuple(p) for p in
                                       kw["image_grid_pinpoints"])
    return LlavaTorchConfig(decoder="deepseek_v3", **kw)


def draw_state(cfg, seed: int, dev, kv_gain_spread: float
               ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``LlavaTorch(cfg)`` in bf16 on ``dev``: one
    draw from a ``torch.Generator`` there for each layer of the tower and
    of the decoder and one for the rest, 0.02 * N(0, 1); the norm gains
    1 + 0.02 * N(0, 1), but ``kv_a_layernorm``'s, exp(``kv_gain_spread``
    * N(0, 1)) where that is not 0; the routers' correction biases 0
    (``balance`` sets them). The tensors are views of those draws."""
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
                           dtype=torch.bfloat16)
        off = 0
        for key, shape in items:
            k = int(np.prod(shape))
            t = flat[off:off + k].view(shape)
            off += k
            if _BIAS.search(key):
                t.zero_()
            elif kv_gain_spread and key.endswith("kv_a_layernorm.weight"):
                t.copy_(torch.exp(kv_gain_spread * t.float()))
            else:
                t.mul_(0.02)
                if _GAIN.search(key):
                    t.add_(1.0)
            state[key] = t
    return {k: state[k] for k in template}


def _balanced(w: torch.Tensor, bias: torch.Tensor, h: torch.Tensor,
              k: int) -> torch.Tensor:
    """The f32 correction bias that evens out the load of a gate of
    weight ``w`` (E, hidden) over its inputs ``h`` (T, hidden), from its
    present ``bias``, by the balancing rule."""
    scores = torch.sigmoid(h @ w.T)
    b = bias.clone()
    n = w.shape[0]
    for i in range(BALANCE_STEPS):
        rate = BALANCE_RATE * BALANCE_FALL ** (i / BALANCE_STEPS)
        ids = torch.topk(scores + b, k, dim=-1).indices
        load = torch.bincount(ids.reshape(-1), minlength=n).to(b.dtype)
        b -= rate * (load / load.mean() - 1.0)
    return b


def _subspace_gate(h: torch.Tensor, n: int, m: int, gen) -> torch.Tensor:
    """(n, hidden) gate weights drawn within the ``m`` directions in which
    the rows of ``h`` (T, hidden) spread the most (the top eigenvectors
    of their covariance): N(0, 1) coordinates there, scaled so that a
    row's norm is that of a drawn row, 0.02 * sqrt(hidden)."""
    hidden = h.shape[1]
    hc = h - h.mean(dim=0, keepdim=True)
    _, vecs = torch.linalg.eigh(hc.T @ hc / h.shape[0])
    g = torch.randn((n, m), generator=gen, device=h.device)
    return (g @ vecs[:, -m:].T) * (0.02 * (hidden / m) ** 0.5)


@torch.no_grad()
def balance(rr, images, seed: int, subspace: int) -> None:
    """Set the routers of ``rr``'s drawn state in place (the program's
    model holds the same tensors): the plain reference's float32 pass
    over a rerank row of each of ``images`` (``llava_moe_ref.calibrate``,
    no program code) gives each expert layer's gate inputs; where
    ``subspace`` > 0 the gate's weights are drawn anew, from a generator
    seeded ``seed``, within that many of its inputs' directions of most
    spread (``_subspace_gate``); then the correction bias is balanced on
    those inputs."""
    from benchmark.reference import llava_moe_ref, llava_ref
    c, state, dev = rr.cfg, rr.state, rr.dev
    llava_ref._no_tf32()
    W = llava_moe_ref.Weights(state)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ids = torch.as_tensor(rr.tok.encode("balance"), device=dev)
    text = W("embed_tokens.weight")[ids]
    x = torch.stack([torch.cat([llava_ref.image_features(W, c, im, dev),
                                text], dim=0) for im in images])

    def before_route(p: str, h: torch.Tensor):
        wk, bk = p + "mlp.gate.weight", p + "mlp.gate.e_score_correction_bias"
        if subspace:
            state[wk].copy_(_subspace_gate(h, c.n_routed_experts, subspace,
                                           gen))
        state[bk].copy_(_balanced(W(wk), W(bk), h, c.num_experts_per_tok))

    llava_moe_ref.calibrate(W, c, x, before_route)
    rr.tok.rows = []


def calibration_images(config: dict, traffic: dict, seed: int, dev, n: int,
                       overrides=None):
    """``n`` camera images of the traffic's kind, from a seed of their
    own."""
    from benchmark.loops import serve
    from leafgrasp_tpu_torch import config as pconfig
    cfg = grasp.pipeline_config(frame_config(config), pconfig, overrides)
    some = dict(traffic, pool_scenes=n, cycle_frames=n)
    return [f[2] for f in serve.frame_cycle(some, seed, cfg.frame.height,
                                            cfg.frame.width, dev, True)]


def watch_experts(seen: dict):
    """Count the grouped expert kernel's calls on a CUDA device until the
    returned function is called: into ``seen["few"]`` or ``seen["many"]``
    (by the port's ``FEW_PAIRS``): their routed pairs added to entry 0,
    the expert weight sets they read to entry 2, a sum on the device.
    Calls made while a CUDA graph is captured are left out, and a
    captured graph's replays call no wrapper: ``_count`` counts those
    from the rerank's shapes."""
    from leafgrasp_tpu_torch.kernels import moe_experts as me
    orig = me.moe_experts

    def wrapped(x, ids, w, *args, counts=None, **kwargs):
        out = orig(x, ids, w, *args, counts=counts, **kwargs)
        if x.device.type == "cuda" and ids.numel() \
                and not torch.cuda.is_current_stream_capturing():
            n = ids.numel()
            acc = seen["few" if n <= me.FEW_PAIRS else "many"]
            if counts is None:
                counts = me.expert_counts(ids, args[0].shape[0])
            read = (counts > 0).sum()
            acc[0] += float(n)
            acc[2] = read if acc[2] is None else acc[2] + read
        return out

    me.moe_experts = wrapped

    def unwatch():
        me.moe_experts = orig
    return unwatch


def build_rerank(config: dict, seed: int, dev, overrides, traffic):
    return Rerank(config, seed, dev, overrides, traffic)


class Rerank(llava_rerank.Rerank):
    """``llava_rerank.Rerank`` over the deepseek_v3 decoder: its own
    configuration, draw, work and reference."""

    def __init__(self, config: dict, seed: int, dev, overrides=None,
                 traffic=None):
        from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
        from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
        from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
        from leafgrasp_tpu_torch.vla.processor import VLAProcessor
        self.config, self.dev = config, dev
        self.check_reranks = int((traffic or {}).get("check_reranks", 6))
        self.num_candidates = int(
            frame_config(config)["pipeline"]["vla"]["num_candidates"])
        self.quantize = None
        self.cfg = model_config(config, overrides)
        self.state = draw_state(self.cfg, seed, dev,
                                float(config["kv_a_layernorm_gain_spread"]))
        self.model = LlavaTorch.from_state(self.cfg, self.state)
        sc = config["scorer"]
        self.tok = FoldTok(min(self.cfg.vocab_size,
                               self.cfg.image_token_index),
                           int(sc["text_tokens"]))
        self.scorer = llava_rerank._Scorer(LlavaTorchScorer(
            self.model, self.tok, max_new_tokens=int(sc["max_new_tokens"]),
            anyres=bool(sc["anyres"])), self.tok)
        self.selector = HybridGraspSelector(VLAProcessor(self.scorer))
        self.records: List[dict] = []
        self._counts = None
        balance(self, calibration_images(
            config, traffic or {}, seed + 17, dev,
            int(config["router_calibration_frames"]), overrides),
            seed + 18, int(config["router_subspace"]))

    def count_work(self, counts: dict):
        super().count_work(counts)
        counts.setdefault("traced_reranks", 0.0)
        # by call size: [routed pairs, experts read (host), (device)]
        self._seen = {"few": [0.0, 0.0, None], "many": [0.0, 0.0, None]}
        self._unwatch = watch_experts(self._seen)

    def stop_counting(self):
        counts, c = self._counts, self.cfg
        super().stop_counting()
        if counts is None:
            return
        self._unwatch()
        for size, (pairs, read, on_card) in self._seen.items():
            if on_card is not None:
                read += float(on_card)
            counts[f"moe_pairs.{size}"] = pairs
            counts[f"moe_flop.{size}"] = work_moe.expert_flop(c, pairs)
            counts[f"moe_bytes.{size}"] = work_moe.expert_bytes(c, pairs,
                                                                read)

    def _count(self, rec):
        c, counts = self.cfg, self._counts
        n_img = int(rec["last"]["n_image_tokens"])
        prompts = [[c.image_token_index] * n_img + r for r in rec["rows"]]
        served = rec["last"]["tokens"]
        fed = [p + list(s[:-1]) for p, s in zip(prompts, served)]
        counts["rerank_flop"] += work_moe.rerank_flop(
            c, prompts, fed, llava_rerank.n_tiles(c, rec["image"]))
        counts["attn_flop"] += work_moe.prefill_attention_flop(c, prompts)
        counts["attn_bytes"] += work_moe.prefill_attention_bytes(c, prompts)
        counts["traced_reranks"] += 1.0
        if rec["last"].get("decode_graph", "eager") != "eager":
            # the replayed steps' expert calls, which no wrapper sees: the
            # pairs from the shapes; of the experts read, the fewest a
            # call can read, one token's k (the share reads low there)
            from leafgrasp_tpu_torch.kernels.moe_experts import FEW_PAIRS
            steps = len(served[0]) - 1 if served else 0
            batches = max(len(rec["last"].get("moe_load", ())), 1)
            n_moe = c.layers - min(c.first_k_dense_replace, c.layers)
            k = c.num_experts_per_tok
            pairs = steps * n_moe * len(served) * k
            size = "few" if -(-len(served) // batches) * k <= FEW_PAIRS \
                else "many"
            self._seen[size][0] += pairs
            self._seen[size][1] += steps * n_moe * batches * k

    def check(self, seed: int, limits: dict, facts: dict):
        from benchmark.reference import llava_moe_ref
        return llava_moe_ref.judge_reranks(self, seed, limits, facts)
