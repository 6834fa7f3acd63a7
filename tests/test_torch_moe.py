"""The deepseek_v3 decoder of ``LlavaTorch`` (latent attention, routed and
shared experts) against the plain float32 reference of the benchmark
(``benchmark/reference/llava_moe_ref.py``) on seeded weights at a tiny
size, on the CPU: full-forward logits, the prompt pass then decode
steps through the latent cache against the reference's full forward,
the router's picks and weights; the expert kernel's and the split-head
flash prefill's plain versions against loops written here.

Everything is float32, so the two sides differ only in the order of
their sums: logits within 1e-4 (values of order one), router weights
within 1e-6.
"""

import dataclasses
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import llava_moe_ref as ref
from leafgrasp_tpu_torch.kernels.flash_prefill import flash_prefill_plain
from leafgrasp_tpu_torch.kernels.moe_experts import (expert_counts,
                                                     moe_experts,
                                                     moe_experts_plain)
from leafgrasp_tpu_torch.vla import llava_torch as lt
from leafgrasp_tpu_torch.vla.layers import STEP, KVCache, Pass
from leafgrasp_tpu_torch.vla.moe import MoE
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = lt.LlavaTorchConfig(
    vis_hidden=16, vis_intermediate=32, vis_layers=1, vis_heads=2,
    image_size=28, patch_size=14, vocab_size=96, hidden=64,
    intermediate=96, layers=3, heads=4, kv_heads=4, image_token_index=90,
    rope_theta=50000.0, decoder="deepseek_v3", kv_lora_rank=32,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
    moe_intermediate_size=24, first_k_dense_replace=1,
    routed_scaling_factor=2.446)
LOGIT_TOL = 1e-4


def _model(cfg=TINY, seed=0, bias_std=0.05):
    model = lt.LlavaTorch(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lt.init_random_(model, gen, std=0.1)
    with torch.no_grad():
        for layer in model.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.e_score_correction_bias.normal_(
                    0.0, bias_std, generator=gen)
    return model


def _weights(model):
    return ref.Weights({k: v.detach() for k, v in
                        model.state_dict().items()})


def _rows(seed=1, b=3, prefix=7, suffix=5, vocab=90):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, prefix)
    return torch.as_tensor(np.stack([np.concatenate(
        [shared, rng.integers(1, vocab, suffix)]) for _ in range(b)]))


def _ref_logits(model, ids, prefix):
    emb = model.embed_tokens.weight.detach()
    return ref.decoder_logits(_weights(model), model.cfg, emb[ids[0, :prefix]],
                              emb[ids[:, prefix:]], 0)


def test_full_forward_logits_match_reference():
    model = _model()
    ids = _rows()
    with torch.no_grad():
        logits, _ = model(ids)
    want = _ref_logits(model, ids, 7)
    got = logits[:, 7:]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= LOGIT_TOL


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_then_latent_cache_decode_match_reference(impl):
    """The generate functions' prompt pass into the latent caches, then
    one step a token through ``_generate_decode_step``'s pass (a cursor
    on the device, the absorbed form): the logits at every read position
    against the reference's full forward over the prompt and the fed
    tokens; rows with unequal left pads."""
    model = _model(seed=3)
    model.set_prefill_attn(impl)
    c = model.cfg
    ids = _rows(seed=4, b=3, prefix=6, suffix=4)
    pads = [0, 2, 5]
    ids[1, :2] = 0
    ids[2, :5] = 0
    feed = torch.as_tensor(np.random.default_rng(5).integers(1, 90, (3, 4)))
    b, t = ids.shape
    pad = torch.tensor(pads, dtype=torch.int32)
    total = t + feed.shape[1]
    caches = KVCache(c, b, total, "cpu")
    positions = torch.clamp(torch.arange(t)[None] - pad[:, None], min=0)
    mask = torch.tril(torch.ones((t, total), dtype=torch.bool))[None, None] \
        & (torch.arange(total)[None, None, None] >= pad[:, None, None, None])
    got = []
    with torch.no_grad():
        logits, caches = model(ids, positions=positions, mask=mask,
                               caches=caches, pad=pad)
        got.append(logits[:, -1])
        for i in range(feed.shape[1]):
            pos = torch.tensor(t + i)
            key = torch.arange(total)
            step_mask = ((key[None] <= pos) & (key[None] >= pad[:, None]))
            step = Pass(STEP, step_mask[:, None, None],
                        cursor=pos.reshape(1), cache=caches)
            logits = model.head(model.decoder(
                model.embed(feed[:, i:i + 1]), (pos - pad)[:, None], step))
            got.append(logits[:, -1])
    got = torch.stack(got, 1)
    emb = model.embed_tokens.weight.detach()
    W = _weights(model)
    for r in range(b):
        row = torch.cat([ids[r, pads[r]:], feed[r]])
        want = ref.decoder_logits(W, c, emb[row[:0]], emb[row][None],
                                  t - pads[r] - 1)[0]
        assert float((got[r] - want).abs().max()) <= LOGIT_TOL, r


def test_decoder_modules_import_one_way():
    """``vla.mla`` imports first in a fresh interpreter, and the model
    layer ``vla.llava_torch`` loads nothing of the parallel layer above
    it."""
    code = ("import sys\n"
            "import leafgrasp_tpu_torch.vla.mla\n"
            "import leafgrasp_tpu_torch.vla.llava_torch\n"
            "up = [m for m in sys.modules\n"
            "      if m.startswith('leafgrasp_tpu_torch.parallel')]\n"
            "assert not up, up\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


def test_router_picks_and_weights_match_reference():
    model = _model(seed=6, bias_std=0.2)
    layer = model.layers[1].mlp
    h = torch.randn((40, TINY.hidden), generator=torch.Generator()
                    .manual_seed(7))
    with torch.no_grad():
        ids, w = layer.gate(h)
    rids, rw = ref.route(_weights(model), TINY, "layers.1.", h)
    order, rorder = ids.argsort(-1), rids.argsort(-1)
    assert torch.equal(ids.gather(1, order), rids.gather(1, rorder))
    assert float((w.gather(1, order) - rw.gather(1, rorder)).abs().max()) \
        <= 1e-6
    assert torch.allclose(w.sum(-1), torch.full((40,), 2.446), atol=1e-5)
    # the correction bias chooses, and only chooses: without it other
    # experts win, and the weights stay the chosen experts' scores
    with torch.no_grad():
        layer.gate.e_score_correction_bias.zero_()
        ids0, _ = layer.gate(h)
    assert not torch.equal(ids0.sort(-1).values, ids.sort(-1).values)


def test_expert_kernel_plain_version_matches_a_token_loop():
    """``moe_experts`` on CPU tensors (the plain version, a loop over the
    experts) against a loop over the tokens and their k experts, with an
    expert that gets no token."""
    gen = torch.Generator().manual_seed(8)
    t, k, e, hid, wid = 30, 3, 6, 16, 12
    x = torch.randn((t, hid), generator=gen)
    ids = torch.stack([torch.randperm(e - 1, generator=gen)[:k]
                       for _ in range(t)])          # expert e-1 idle
    w = torch.rand((t, k), generator=gen)
    wg, wu = torch.randn((2, e, wid, hid), generator=gen)
    wd = torch.randn((e, hid, wid), generator=gen)
    got = moe_experts(x, ids, w, wg, wu, wd)
    want = torch.zeros_like(x)
    for i in range(t):
        for j in range(k):
            ex = int(ids[i, j])
            g, u = wg[ex] @ x[i], wu[ex] @ x[i]
            want[i] += w[i, j] * (wd[ex] @ (torch.nn.functional.silu(g) * u))
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)
    assert moe_experts_plain(x, ids, w, wg, wu, wd).shape == x.shape
    counts = expert_counts(ids, e)
    assert int(counts[e - 1]) == 0 and int(counts.sum()) == t * k


@pytest.mark.parametrize("pads", [(0, 0), (3, 0), (0, 8)])
def test_flash_prefill_plain_with_split_heads_matches_a_loop(pads):
    """The flash prefill's plain version with q and k of one head size
    and v of another (latent attention's split heads): causal attention
    over the keys from each row's pad at scale 1 / sqrt(q's head size),
    pad rows zero."""
    gen = torch.Generator().manual_seed(9)
    b, t, h, dk, dv = 2, 9, 3, 24, 8
    q = torch.randn((b, t, h, dk), generator=gen)
    k = torch.randn((b, t + 2, h, dk), generator=gen)
    v = torch.randn((b, t + 2, h, dv), generator=gen)
    pad = torch.tensor(pads, dtype=torch.int32)
    got = flash_prefill_plain(q, k, v, pad, chunk=4)
    assert got.shape == (b, t, h, dv)
    for r in range(b):
        p = pads[r]
        assert not got[r, :p].any()
        for i in range(p, t):
            s = torch.einsum("hd,jhd->hj", q[r, i], k[r, p:i + 1]) \
                / math.sqrt(dk)
            want = torch.einsum("hj,jhd->hd", torch.softmax(s, -1),
                                v[r, p:i + 1])
            assert torch.allclose(got[r, i], want, atol=1e-5)


def test_config_from_hf_reads_the_deepseek_fields():
    """A HF-style config of the LLaVA-NeXT stack over Moonlight's decoder
    gives the deepseek_v3 kind with its published sizes."""
    from types import SimpleNamespace as NS
    text = NS(model_type="deepseek_v3", vocab_size=163840, hidden_size=2048,
              intermediate_size=11264, num_hidden_layers=27,
              num_attention_heads=16, num_key_value_heads=16,
              rope_theta=50000.0, rms_norm_eps=1e-5, q_lora_rank=None,
              kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
              v_head_dim=128, n_routed_experts=64, num_experts_per_tok=6,
              n_shared_experts=2, moe_intermediate_size=1408,
              first_k_dense_replace=1, routed_scaling_factor=2.446,
              norm_topk_prob=True, n_group=1, topk_group=1)
    vision = NS(hidden_size=1024, intermediate_size=4096,
                num_hidden_layers=24, num_attention_heads=16,
                image_size=336, patch_size=14)
    cfg = lt.config_from_hf(NS(vision_config=vision, text_config=text,
                               vision_feature_layer=-2,
                               image_token_index=163839))
    assert cfg.mla and cfg.rope_dim == 64 and cfg.n_routed_experts == 64
    assert (cfg.kv_lora_rank, cfg.v_head_dim) == (512, 128)
    with pytest.raises(ValueError):
        lt.config_from_hf(NS(vision_config=vision, text_config=NS(
            **dict(vars(text), q_lora_rank=1536)), vision_feature_layer=-2,
            image_token_index=1))
    with pytest.raises(ValueError):
        lt.LlavaTorch(dataclasses.replace(TINY, lora_rank=4), device="meta")


def _shared_rows(seed, n, texts, image_token=90):
    rng = np.random.default_rng(seed)
    t = n + max(texts)
    ids = np.zeros((len(texts), t), np.int64)
    pads = []
    for r, m in enumerate(texts):
        p = t - n - m
        ids[r, p:p + n] = image_token
        ids[r, p + n:] = rng.integers(1, 90, m)
        pads.append(p)
    return torch.from_numpy(ids), pads


def _first_logits(model, ids, feats, pads, timings):
    seen = []
    hook = model.lm_head.register_forward_hook(
        lambda _m, _a, out: seen.append(out.detach().clone()))
    try:
        toks = lt.greedy_generate_llava(model, ids, image_features=feats,
                                        max_new_tokens=5, pad_lens=pads,
                                        timings=timings)
    finally:
        hook.remove()
    return toks, [x for x in seen if x.shape[0] == ids.shape[0]][0][:, -1]


@pytest.mark.parametrize("impl,n", [("chunked", 9), ("flash", 130)])
@pytest.mark.parametrize("texts", [(6, 6, 6), (6, 2, 11)])
def test_shared_prefix_route_equals_the_single_pass(impl, n, texts):
    """The deepseek_v3 decoder on the shared route (the prefix once, its
    latents written into every row, the rows' text over every cached
    latent up to its slot, expanded, at the prefix's query offset): the
    first logits within 1e-4 of the single pass over every row, the
    tokens equal, rows of equal and of unequal length; a long prefix
    takes the flash route's plain version in both attentions. The two
    prompt passes' latent caches agree within 1e-4 in every slot from
    each row's pad."""
    model = _model(seed=11)
    model.set_prefill_attn(impl)
    feats = torch.randn((1, n, TINY.hidden),
                        generator=torch.Generator().manual_seed(12))
    ids, pads = _shared_rows(13, n, texts)
    t_shared, t_full = {}, {}
    with torch.no_grad():
        got, got_first = _first_logits(model, ids, feats, pads, t_shared)
        want, want_first = _first_logits(
            model, ids, feats.expand(len(texts), -1, -1), pads, t_full)
    assert (t_shared["prefill_route"], t_full["prefill_route"]) \
        == ("shared", "full")
    assert float((got_first - want_first).abs().max()) <= LOGIT_TOL
    assert torch.equal(got, want)
    b, t = ids.shape
    shared, full = (KVCache(model.cfg, b, t + 5, "cpu") for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32)
    with torch.no_grad():
        lt._generate_prefill_shared(model, ids, pad, pads, feats, shared)
        lt._generate_prefill(model, ids, pad, None, feats.expand(b, -1, -1),
                             full)
    for r, p in enumerate(pads):                 # (layers, rows, slots, ...)
        gap = (shared.data[:, r, p:] - full.data[:, r, p:]).abs().max()
        assert float(gap) <= LOGIT_TOL


def test_moe_load_covers_the_whole_prompt_of_the_shared_route(monkeypatch):
    """``moe_load`` covers the whole prompt on the shared route: the
    routed pairs of the prefix's N tokens, once, and of every row's
    slots from N, in the one pass's counts."""
    from leafgrasp_tpu_torch.vla import moe
    model = _model(seed=14)
    n, texts = 9, (6, 2, 11)
    feats = torch.randn((1, n, TINY.hidden),
                        generator=torch.Generator().manual_seed(15))
    ids, pads = _shared_rows(16, n, texts)
    passes = []
    real = moe.expert_pairs
    monkeypatch.setattr(moe, "expert_pairs",
                        lambda r: passes.append(real(r)) or passes[-1])
    timings = {}
    with torch.no_grad():
        lt.greedy_generate_llava(model, ids, image_features=feats,
                                 max_new_tokens=3, pad_lens=pads,
                                 timings=timings)
    k = TINY.num_experts_per_tok
    t = ids.shape[1]
    assert len(passes) == 1
    assert passes[0].sum(1).tolist() == [(n + 3 * (t - n)) * k] * 2
    assert torch.equal(timings["moe_load"], moe.moe_load(passes[0]))


def test_scorer_keeps_one_moe_load_a_generate_call():
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer

    class Tok:
        def encode(self, text):
            return [1 + len(text) % 7, 2 + len(text) % 5] \
                + [3 + ord(ch) % 80 for ch in text[:6 + len(text) % 4]]

        def decode(self, ids):
            return "0." + "".join(str(int(i) % 10) for i in ids)

    model = _model(seed=17)
    scorer = LlavaTorchScorer(model, Tok(), max_new_tokens=3)
    cands = [dict(leaf_id=i + 1, x=float(10 + 7 * i), y=float(30 - 3 * i),
                  clutter_score=0.2 + 0.1 * i, distance_score=0.9 - 0.1 * i,
                  geometric_score=0.5 + 0.05 * i) for i in range(5)]
    image = np.random.default_rng(18).integers(0, 256, (40, 30, 3)) \
        .astype(np.uint8)
    for max_batch, calls, route in ((None, 1, "shared"), (2, 3, "full"),
                                    (1, 5, "full")):
        scorer.max_batch = max_batch
        scorer.score(image, cands, "Select")
        assert len(scorer.last["moe_load"]) == calls
        assert scorer.last["prefill_route"] == route


def test_latent_decode_keeps_its_mask_and_records_no_decode_attention(
        monkeypatch):
    """The deepseek_v3 decoder's steps keep the absorbed form under the
    step's mask: ``kernels/decode_attention`` is never called, the steps
    give the same tokens as with ``Pass.decode_kernel`` off, and
    ``timings`` has no ``decode_attention``."""
    from leafgrasp_tpu_torch.kernels import decode_attention as da
    model = _model(seed=19)
    ids = _rows(20)
    pad = torch.tensor([0, 2, 5], dtype=torch.int32)
    ids[torch.arange(ids.shape[1])[None, :] < pad[:, None]] = 0
    calls = []
    monkeypatch.setattr(da, "decode_attention", lambda *a: calls.append(1))
    timings = {}
    got = lt.greedy_generate_llava(model, ids, max_new_tokens=5,
                                   pad_lens=pad, timings=timings)
    assert calls == [] and "decode_attention" not in timings
    assert timings["decode_graph"] == "eager"
    monkeypatch.setattr(Pass, "decode_kernel", lambda self: False)
    assert torch.equal(lt.greedy_generate_llava(model, ids, max_new_tokens=5,
                                                pad_lens=pad), got)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("pads", [(0, 0), (3, 12), (16, 30)])
def test_flash_prefill_plain_with_an_offset_is_the_last_rows(split, pads):
    """The plain version at a query offset o equals the last rows of the
    same attention over every row from 0 (pad rows included: a pad past
    o makes some of the offset rows pad rows, exactly zero), with the
    log-sum-exp; one query head a K/V head and two; the query offset
    reads the first o + t rows of a longer K/V only."""
    gen = torch.Generator().manual_seed(19)
    b, o, t = 2, 17, 9
    h, kvh, dk, dv = (3, 3, 24, 8) if split else (4, 2, 16, 16)
    q = torch.randn((b, o + t, h, dk), generator=gen)
    k = torch.randn((b, o + t + 4, kvh, dk), generator=gen)
    v = torch.randn((b, o + t + 4, kvh, dv), generator=gen)
    k[:, o + t:] = float("nan")
    v[:, o + t:] = float("nan")
    pad = torch.tensor(pads, dtype=torch.int32)
    full, lse = flash_prefill_plain(q, k, v, pad, return_lse=True)
    got, got_lse = flash_prefill_plain(q[:, o:], k, v, pad, o, chunk=4,
                                       return_lse=True)
    assert got.shape == (b, t, h, dv)
    assert torch.allclose(got, full[:, o:], atol=1e-6, rtol=1e-6)
    assert torch.equal(torch.isfinite(got_lse), torch.isfinite(lse[..., o:]))
    real = torch.isfinite(got_lse)
    assert torch.allclose(got_lse[real], lse[..., o:][real], atol=1e-5)
    for r, p in enumerate(pads):
        assert not got[r, :max(p - o, 0)].any()
    with pytest.raises(ValueError):
        flash_prefill_plain(q[:, o:], k[:, :o + t - 1], v[:, :o + t - 1],
                            pad, o)
