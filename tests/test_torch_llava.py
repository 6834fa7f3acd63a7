"""The port's LLaVA stack against the JAX package's, on the CPU at tiny
widths: the same seeded weights (crossed through ``vla/convert.py``) and
the same numpy inputs go through both.

The JAX package's flash route (a Pallas TPU kernel) engages only on the
TPU backend, so on the CPU the JAX functions below take their dense or
chunked route, which the JAX package states to be the same function; the
port's ``"flash"`` route on CPU tensors takes the kernel's plain version.

Tolerances: f32 logits and features 1e-4 relative with 1e-5 absolute
(different orders of f32 sums in the two frameworks' matrix products),
greedy tokens and parsed scores equal; bf16 logits within 0.15 absolute
on logits of magnitude around 3 (the two frameworks round bf16
intermediates at different places inside fused elementwise chains);
resized images equal to the grey level.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leafgrasp_tpu.vla import llava_jax as jl
from leafgrasp_tpu.vla import llava_next as jn
from leafgrasp_tpu.vla import llava_runtime as jr
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import llava_next as tn
from leafgrasp_tpu_torch.vla import llava_runtime as tr
from leafgrasp_tpu_torch.vla import llava_torch as tl
from leafgrasp_tpu_torch.vla.layers import PROMPT, KVCache, Pass

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 0.15

TINY = dict(vis_hidden=32, vis_intermediate=64, vis_layers=2, vis_heads=2,
            image_size=28, patch_size=14, vocab_size=128, hidden=64,
            intermediate=96, layers=2, heads=4, kv_heads=2,
            image_token_index=100)
PINPOINTS = ((28, 56), (56, 28), (56, 56))


def _configs(**kw):
    fields = {**TINY, **kw}
    return jl.LlavaJaxConfig(**fields), tl.LlavaTorchConfig(**fields)


def _noisy_variables(jcfg, seed=0, newline=False):
    """Flax init, then every leaf moved by seeded numpy noise so that no
    gain is exactly one and no bias exactly zero."""
    model = jl.LlavaJax(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    px = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), ids, pixel_values=px)
    rng = np.random.default_rng(seed + 100)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
        .astype(np.float32), variables)
    if newline:
        variables["params"]["image_newline"] = \
            0.3 * rng.standard_normal(jcfg.hidden).astype(np.float32)
    return model, variables


def _pair(seed=0, newline=False, **kw):
    jcfg, tcfg = _configs(**kw)
    jmodel, variables = _noisy_variables(jcfg, seed, newline)
    tmodel = tl.LlavaTorch(tcfg, device="cpu")
    tmodel.load_state_dict(convert.flax_to_torch_llava(variables))
    return jmodel, variables, tmodel


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), rtol=rtol, atol=atol)


def _inputs(seed, b=2, t=12, n_img=4, image_size=28):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 99, (b, t)).astype(np.int32)
    ids[:, 1:1 + n_img] = 100
    px = rng.standard_normal((b, image_size, image_size, 3)) \
        .astype(np.float32)
    return ids, px


# ---- modules ---------------------------------------------------------------------

def test_clip_tower_matches_jax():
    jmodel, variables, tmodel = _pair()
    _, px = _inputs(1)
    want = jl.ClipVisionTower(jmodel.cfg).apply(
        {"params": variables["params"]["vision_tower"]}, jnp.asarray(px))
    got = tmodel.vision_tower(torch.from_numpy(px))
    assert got.shape == (2, 4, 32)
    _close(got, want)


@pytest.mark.parametrize("feature_layer,drop_cls", [(-2, True), (-1, False),
                                                    (1, True)])
def test_vision_project_matches_jax(feature_layer, drop_cls):
    jmodel, variables, tmodel = _pair(vision_feature_layer=feature_layer,
                                      drop_cls_token=drop_cls)
    _, px = _inputs(2)
    want = jl._VisionProject(jmodel.cfg).apply(variables, jnp.asarray(px))
    got = tmodel.vision_project(torch.from_numpy(px))
    assert got.shape == (2, 4 + (not drop_cls), 64)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_hf_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = jl._rope_hf(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6)
    got = tl._rope_hf(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(pos), 1e6)
    assert str(got.dtype) == f"torch.{dtype}"
    # bf16: one rounding of the same f32 value, up to an ulp where the
    # two cos/sin differ in the last bit
    _close(got, want, rtol=1e-5 if dtype == "float32" else 2.0 ** -7,
           atol=1e-5)


def _layer_io(seed, b=2, t=9, total=14, pads=(0, 3)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 64)).astype(np.float32)
    pad = np.asarray(pads, np.int32)
    positions = np.maximum(np.arange(t)[None] - pad[:, None], 0)
    mask = np.tril(np.ones((t, total), bool))[None, None] \
        & (np.arange(total)[None, None, None] >= pad[:, None, None, None])
    return x, positions.astype(np.int32), mask, pad


@pytest.mark.parametrize("with_cache", [False, True])
def test_mistral_layer_matches_jax(with_cache):
    jmodel, variables, tmodel = _pair()
    total = 14
    x, positions, mask, _ = _layer_io(4, total=total)
    b, t = x.shape[:2]
    jcache, tcache = None, ()
    if with_cache:
        shape = (b, total, 2, 16)
        jcache = (jnp.zeros(shape), jnp.zeros(shape), jnp.int32(0))
        tcache = (torch.zeros(shape), torch.zeros(shape))
    else:
        mask = mask[..., :t]
    want, jnew = jl._MistralLayer(jmodel.cfg).apply(
        {"params": variables["params"]["layer_0"]}, jnp.asarray(x),
        jnp.asarray(positions), jnp.asarray(mask), jcache)
    rope = tl._rope_tables(torch.from_numpy(positions), 16, 1e6)
    got = tmodel.layers[0](torch.from_numpy(x), rope,
                           Pass(PROMPT, torch.from_numpy(mask), kv=tcache))
    # rows 0..2 of the second example are left pad: unread downstream
    _close(got[0], want[0])
    _close(got[1, 3:], want[1, 3:])
    if with_cache:                           # written in place
        assert int(jnew[2]) == t
        _close(tcache[0][:, :t], jnew[0][:, :t])
        _close(tcache[1][:, :t], jnew[1][:, :t])


@pytest.mark.parametrize("how", ["pixel_values", "image_features",
                                 "last_only", "text_only"])
def test_logits_match_jax(how):
    jmodel, variables, tmodel = _pair()
    ids, px = _inputs(5)
    jkw, tkw = {}, {}
    if how == "image_features":
        feats = np.random.default_rng(6).standard_normal((2, 4, 64)) \
            .astype(np.float32)
        jkw["image_features"] = jnp.asarray(feats)
        tkw["image_features"] = torch.from_numpy(feats)
    elif how != "text_only":
        jkw["pixel_values"] = jnp.asarray(px)
        tkw["pixel_values"] = torch.from_numpy(px)
    last = how == "last_only"
    want, _ = jmodel.apply(variables, jnp.asarray(ids),
                           logits_last_only=last, **jkw)
    with torch.no_grad():
        got, caches = tmodel(torch.from_numpy(ids).long(),
                             logits_last_only=last, **tkw)
    assert caches is None
    assert got.shape == (2, 1 if last else 12, 128)
    _close(got, want)


def test_image_token_splice_order_matches_jax():
    """Features broadcast to (b, N, hidden) with b * N image tokens at
    different places in each row: the k-th image token of the flattened
    batch takes the k-th feature row."""
    jmodel, variables, tmodel = _pair()
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 99, (3, 10)).astype(np.int32)
    for row, start in enumerate((0, 3, 7)):
        ids[row, start:start + 3] = 100
    feats = np.broadcast_to(rng.standard_normal((1, 3, 64))
                            .astype(np.float32), (3, 3, 64)).copy()
    want, _ = jmodel.apply(variables, jnp.asarray(ids),
                           image_features=jnp.asarray(feats))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        image_features=torch.from_numpy(feats))
    _close(got, want)


def test_sliding_window_logits_and_tokens_match_jax():
    jmodel, variables, tmodel = _pair(sliding_window=5)
    ids, px = _inputs(8, t=14)
    want, _ = jmodel.apply(variables, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        pixel_values=torch.from_numpy(px))
    _close(got, want)
    pad = np.array([0, 2], np.int32)
    jt = jl.greedy_generate_llava(jmodel, variables, jnp.asarray(ids),
                                  pixel_values=jnp.asarray(px),
                                  max_new_tokens=6, pad_lens=pad)
    tt = tl.greedy_generate_llava(tmodel, torch.from_numpy(ids).long(),
                                  pixel_values=torch.from_numpy(px),
                                  max_new_tokens=6, pad_lens=pad)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_bf16_logits_close_to_jax_bf16():
    """f32 parameters, bf16 compute type: the promotion rules of the
    JAX modules (f32 after a norm's gain, bf16 after a projection, an
    f32 ``lm_head``) are mirrored, so logits agree to bf16 rounding."""
    jmodel, variables, tmodel = _pair(dtype="bfloat16")
    ids, px = _inputs(9)
    want, _ = jmodel.apply(variables, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        pixel_values=torch.from_numpy(px))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    _close(got, want, rtol=0, atol=BF16_ATOL)


def test_bf16_parameters_keep_bf16_end_to_end():
    """The serving build: bf16 parameters, so every activation and the
    logits are bf16, as in the JAX package."""
    jcfg, tcfg = _configs(dtype="bfloat16")
    jmodel, variables = _noisy_variables(jcfg)
    tmodel = tl.LlavaTorch(tcfg, device="cpu", param_dtype=torch.bfloat16)
    tmodel.load_state_dict(convert.flax_to_torch_llava(variables))
    assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    ids, px = _inputs(10)
    jvars = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), variables)
    want, _ = jmodel.apply(jvars, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        pixel_values=torch.from_numpy(px))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, rtol=0, atol=2 * BF16_ATOL)


# ---- generation --------------------------------------------------------------------

@pytest.mark.parametrize("decode_mode", ["scan", "steps"])
def test_greedy_generate_with_pad_lens_matches_jax(decode_mode):
    jmodel, variables, tmodel = _pair()
    ids, px = _inputs(11, b=3, t=13)
    pad = np.array([0, 2, 5], np.int32)
    for row, p in enumerate(pad):         # right-aligned rows
        ids[row] = np.roll(ids[row], p)
        ids[row, :p] = 0
    feats = np.asarray(jl._VisionProject(jmodel.cfg).apply(
        variables, jnp.asarray(px[:1])))
    feats3 = np.broadcast_to(feats, (3,) + feats.shape[1:]).copy()
    jt = jl.greedy_generate_llava(jmodel, variables, jnp.asarray(ids),
                                  image_features=jnp.asarray(feats3),
                                  max_new_tokens=7, pad_lens=pad,
                                  decode_mode=decode_mode)
    tt = tl.greedy_generate_llava(tmodel, torch.from_numpy(ids).long(),
                                  image_features=torch.from_numpy(feats3),
                                  max_new_tokens=7, pad_lens=pad,
                                  decode_mode=decode_mode)
    assert tt.dtype == torch.int32 and tt.shape == (3, 7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    with pytest.raises(ValueError):
        tl.greedy_generate_llava(tmodel, torch.from_numpy(ids).long(),
                                 decode_mode="graph")


def _long_prompt(seed, b=3, t=150, pads=(0, 9, 140)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 99, (b, t)).astype(np.int64)
    pad = np.asarray(pads, np.int32)
    for row, p in enumerate(pad):
        ids[row, :p] = 0
    return ids, pad


def test_flash_route_equals_chunked_and_dense_on_cpu():
    """t >= 128 with unequal pads: on CPU tensors the flash route takes
    the kernel's plain version, which must give the tokens and the
    prompt-pass logits of the chunked and of the dense route; the JAX
    package (chunked on the CPU) gives the same tokens."""
    jmodel, variables, tmodel = _pair(prefill_attn_impl="flash",
                                      prefill_attn_chunk=64)
    ids, pad = _long_prompt(12)
    kernels.reset_launch_counts()
    outs, logits = {}, {}
    for route, (impl, chunk) in {"flash": ("flash", 64),
                                 "chunked": ("chunked", 64),
                                 "dense": ("chunked", None)}.items():
        tmodel.set_prefill_attn(impl, chunk=chunk)
        outs[route] = tl.greedy_generate_llava(
            tmodel, torch.from_numpy(ids), max_new_tokens=5, pad_lens=pad)
        with torch.no_grad():
            logits[route] = tmodel(torch.from_numpy(ids))[0]
    assert set(kernels.launch_counts().values()) == {0}
    for route in ("chunked", "dense"):
        assert torch.equal(outs["flash"], outs[route])
        np.testing.assert_allclose(logits["flash"].numpy(),
                                   logits[route].numpy(), rtol=RTOL,
                                   atol=ATOL)
    jt = jl.greedy_generate_llava(jmodel, variables,
                                  jnp.asarray(ids, jnp.int32),
                                  max_new_tokens=5, pad_lens=pad)
    np.testing.assert_array_equal(outs["flash"].numpy(), np.asarray(jt))


def test_flash_route_needs_the_callers_word_on_the_mask(monkeypatch):
    """A caller that hands the model its own mask, without ``pad``, gets
    the dense or chunked route, whatever the mask looks like."""
    _, _, tmodel = _pair(prefill_attn_impl="flash")
    ids, _ = _long_prompt(13, b=1, pads=(0,))
    calls = []
    real = tl._fp.flash_prefill
    monkeypatch.setattr(tl._fp, "flash_prefill",
                        lambda *a: calls.append(1) or real(*a))
    t = ids.shape[1]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool))[None, None]
    with torch.no_grad():
        a, _ = tmodel(torch.from_numpy(ids), mask=mask)
        assert calls == []
        b, _ = tmodel(torch.from_numpy(ids))          # causal by default
        assert len(calls) == tmodel.cfg.layers
        tmodel(torch.from_numpy(ids[:, :100]))        # under 128 tokens
        assert len(calls) == tmodel.cfg.layers
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_flash_route_does_not_ask_what_the_kernel_is_built_for(monkeypatch):
    """The route engages on the configuration and the mask alone: a head
    size the kernel is not instantiated for still reaches the wrapper
    (which serves CPU tensors by the plain version and raises on the
    card), never another route."""
    from leafgrasp_tpu_torch.kernels import flash_prefill as fp
    _, _, tmodel = _pair(prefill_attn_impl="flash")
    cfg = tmodel.cfg
    assert cfg.hidden // cfg.heads not in fp._HEAD_DIMS
    ids, _ = _long_prompt(14, b=1, pads=(0,))
    seen = []
    real = tl._fp.flash_prefill
    monkeypatch.setattr(tl._fp, "flash_prefill",
                        lambda q, *a: seen.append(q.shape[-1]) or real(q, *a))
    with torch.no_grad():
        tmodel(torch.from_numpy(ids))
    assert seen == [cfg.hidden // cfg.heads] * cfg.layers


def test_unported_options_raise_and_name_the_later_slice():
    # quantized serving and the HF loader are ported now: they build and
    # load (tests/test_torch_quant.py, tests/test_torch_checkpoint_io.py)
    _, tcfg = _configs(quantized=True)
    assert isinstance(tl.LlavaTorch(tcfg, device="cpu").lm_head,
                      tl.QuantDense)
    _, _, tmodel = _pair()
    with pytest.raises(ValueError, match="auto"):
        tr.LlavaTorchScorer(tmodel, _Tok(), decode_weight_layout="auto")
    with pytest.raises(ValueError, match="pinpoints"):
        tr.LlavaTorchScorer(tmodel, _Tok(), anyres=True)
    with pytest.raises(FileNotFoundError):    # a local directory only
        tr.load_llava_from_hf("/nonexistent", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to check")
        tl.LlavaTorch(_configs()[1])                  # device=None


# ---- converters --------------------------------------------------------------------

def _hf_state_dict(cfg, seed, nest):
    """A random state_dict under HuggingFace's LLaVA key names."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape))
                                .astype(np.float32))

    sd = {}
    vt = "vision_tower.vision_model"
    d, hid = cfg.vis_hidden, cfg.hidden
    sd[f"{vt}.embeddings.class_embedding"] = t(d)
    sd[f"{vt}.embeddings.position_embedding.weight"] = \
        t(cfg.num_patches + 1, d)
    sd[f"{vt}.embeddings.patch_embedding.weight"] = \
        t(d, 3, cfg.patch_size, cfg.patch_size)
    for name in ("weight", "bias"):
        sd[f"{vt}.pre_layrnorm.{name}"] = t(d)
    for i in range(cfg.vis_layers):
        li = f"{vt}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{li}.{ln}.weight"], sd[f"{li}.{ln}.bias"] = t(d), t(d)
        for pr in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{li}.self_attn.{pr}.weight"] = t(d, d)
            sd[f"{li}.self_attn.{pr}.bias"] = t(d)
        sd[f"{li}.mlp.fc1.weight"] = t(cfg.vis_intermediate, d)
        sd[f"{li}.mlp.fc1.bias"] = t(cfg.vis_intermediate)
        sd[f"{li}.mlp.fc2.weight"] = t(d, cfg.vis_intermediate)
        sd[f"{li}.mlp.fc2.bias"] = t(d)
    sd["multi_modal_projector.linear_1.weight"] = t(hid, d)
    sd["multi_modal_projector.linear_1.bias"] = t(hid)
    sd["multi_modal_projector.linear_2.weight"] = t(hid, hid)
    sd["multi_modal_projector.linear_2.bias"] = t(hid)
    lm = "language_model.model" if nest == "old" else "language_model"
    sd[f"{lm}.embed_tokens.weight"] = t(cfg.vocab_size, hid)
    kv = cfg.kv_heads * cfg.head_dim
    for i in range(cfg.layers):
        li = f"{lm}.layers.{i}"
        sd[f"{li}.input_layernorm.weight"] = 1 + t(hid)
        sd[f"{li}.post_attention_layernorm.weight"] = 1 + t(hid)
        sd[f"{li}.self_attn.q_proj.weight"] = t(hid, hid)
        sd[f"{li}.self_attn.k_proj.weight"] = t(kv, hid)
        sd[f"{li}.self_attn.v_proj.weight"] = t(kv, hid)
        sd[f"{li}.self_attn.o_proj.weight"] = t(hid, hid)
        sd[f"{li}.mlp.gate_proj.weight"] = t(cfg.intermediate, hid)
        sd[f"{li}.mlp.up_proj.weight"] = t(cfg.intermediate, hid)
        sd[f"{li}.mlp.down_proj.weight"] = t(hid, cfg.intermediate)
    sd[f"{lm}.norm.weight"] = 1 + t(hid)
    sd["lm_head.weight"] = t(cfg.vocab_size, hid)
    sd["image_newline"] = t(hid)
    if nest == "new":
        sd = {(k if k.startswith("lm_head") else "model." + k): v
              for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("nest", ["old", "new"])
@pytest.mark.parametrize("lora_rank", [0, 4])
def test_convert_hf_state_dict_matches_jax_converter(nest, lora_rank):
    jcfg, tcfg = _configs(lora_rank=lora_rank,
                          image_grid_pinpoints=PINPOINTS)
    sd = _hf_state_dict(tcfg, 14, nest)
    jmodel = jl.LlavaJax(jcfg)
    jvars = jl.convert_hf_llava_state_dict(sd, jcfg)
    state = tl.convert_hf_llava_state_dict(sd, tcfg)
    tmodel = tl.LlavaTorch(tcfg, device="cpu")
    if lora_rank:
        jvars = jl.attach_lora(jmodel, jvars, jax.random.PRNGKey(1))
        gen = torch.Generator()
        gen.manual_seed(1)
        tl.attach_lora(tmodel, state, gen)
        assert float(tmodel.layers[0].gate_proj.lora_a.detach().abs().max()) > 0
        assert not tmodel.layers[0].gate_proj.lora_b.any()
        with pytest.raises(KeyError):
            tl.attach_lora(tmodel, {"norm.weight": state["norm.weight"]},
                           gen)
    else:
        tmodel.load_state_dict(state)
    assert torch.equal(tmodel.image_newline, sd[
        "image_newline" if nest == "old" else "model.image_newline"])
    ids, px = _inputs(15)
    want, _ = jmodel.apply(jvars, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        pixel_values=torch.from_numpy(px))
    _close(got, want)           # fresh adapters start as no change


def test_config_from_hf_matches_jax():
    hf = types.SimpleNamespace(
        vision_config=types.SimpleNamespace(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=28, patch_size=14),
        text_config=types.SimpleNamespace(
            vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=5e5, rms_norm_eps=1e-5,
            sliding_window=4096),
        vision_feature_layer=-2, vision_feature_select_strategy="full",
        image_token_index=100,
        image_grid_pinpoints=[[28, 56], [56, 28]])
    # quant_packed picks the JAX package's int4 storage; the port stores
    # int4 nibble-packed only and has no such field. The port's decoder
    # kind and the deepseek_v3 fields, which the JAX package lacks, are
    # the Mistral decoder's defaults for a Mistral config
    want = dataclasses.asdict(jl.config_from_hf(hf))
    assert want.pop("quant_packed") is False
    got = dataclasses.asdict(tl.config_from_hf(hf))
    port_only = {f.name: f.default for f in dataclasses.fields(
        tl.LlavaTorchConfig) if f.name not in want}
    assert set(port_only) == {
        "decoder", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "n_routed_experts", "num_experts_per_tok",
        "n_shared_experts", "moe_intermediate_size",
        "first_k_dense_replace", "routed_scaling_factor", "norm_topk_prob"}
    assert {k: got.pop(k) for k in port_only} == port_only
    assert port_only["decoder"] == "mistral"
    assert got == want


ARCH = dict(vis_hidden=64, vis_intermediate=128, vis_layers=2, vis_heads=4,
            image_size=28, patch_size=14, vocab_size=272, hidden=128,
            intermediate=256, layers=3, heads=4, kv_heads=2,
            image_token_index=264)


def _arch_models():
    """The LLaVA-arch LoRA scorer of artifacts/vla (the pretrained base
    in the frozen slots, then the adapter), in JAX and in the port.

    The base file holds adapter-free names. The JAX package puts such a
    tree into the frozen slots with ``graft_base_params``; its
    ``attach_lora`` alone (as tools/eval_vla_system.py calls it) would
    leave them at their fresh initialization beside unused leaves."""
    import flax.traverse_util as tu
    from leafgrasp_tpu.vla.lora import graft_base_params, merge_lora_params
    base = np.load("artifacts/vla/llava_arch_base.npz")
    adapter = np.load("artifacts/vla/llava_arch_adapter.npz")
    jcfg = jl.LlavaJaxConfig(**ARCH, lora_rank=8, lora_alpha=16.0)
    jmodel = jl.LlavaJax(jcfg)
    fresh = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32),
                        pixel_values=jnp.zeros((1, 28, 28, 3)))
    grafted = graft_base_params(fresh["params"], tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in base.items()}))
    jvars = {"params": merge_lora_params(grafted, tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in adapter.items()}))}
    tmodel = tl.LlavaTorch(tl.LlavaTorchConfig(**ARCH, lora_rank=8,
                                               lora_alpha=16.0),
                           device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    from leafgrasp_tpu_torch.vla.lora import merge_lora_params as tmerge
    tl.attach_lora(tmodel, tmerge(convert.flax_to_torch_llava(base),
                                  convert.flax_to_torch_llava(adapter)), gen)
    return jmodel, jvars, tmodel


def test_lora_artifacts_load_and_match_jax():
    jmodel, jvars, tmodel = _arch_models()
    assert float(tmodel.layers[0].down_proj.lora_b.detach().abs().max()) > 0
    ids, px = _inputs(16)
    ids = np.where(ids == 100, 264, ids)
    want, _ = jmodel.apply(jvars, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(),
                        pixel_values=torch.from_numpy(px))
    _close(got, want)


def test_lora_scorer_scores_equal_jax():
    from leafgrasp_tpu.vla.lm import ByteTokenizer as JTok
    from leafgrasp_tpu_torch.vla.lm import ByteTokenizer
    jmodel, jvars, tmodel = _arch_models()
    rng = np.random.default_rng(17)
    image = rng.random((40, 52, 3)).astype(np.float32)
    cands = _candidates(17, 3)
    want = jr.LlavaJaxScorer(jmodel, jvars, JTok(), max_new_tokens=6) \
        .score(image, cands, "Select the best leaf")
    scorer = tr.LlavaTorchScorer(tmodel, ByteTokenizer(), max_new_tokens=6)
    got = scorer.score(image, cands, "Select the best leaf")
    assert got == want
    assert scorer.last["n_image_tokens"] == 4


# ---- anyres ------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(96, 128), (128, 96), (50, 50), (30, 200),
                                (1080, 1440)])
def test_anyres_geometry_matches_jax(hw):
    pins = PINPOINTS if hw[0] < 1000 else (
        (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008))
    size = 28 if hw[0] < 1000 else 336
    assert tn.select_best_resolution(hw, pins) == \
        jn.select_best_resolution(hw, pins)
    assert tn.anyres_grid_shape(hw, pins, size) == \
        jn.anyres_grid_shape(hw, pins, size)
    cfg = types.SimpleNamespace(image_size=size, patch_size=14)
    assert tn._pack_plan(hw, pins, cfg) == jn._pack_plan(hw, pins, cfg)
    if hw == (1080, 1440):
        # the production frame: (672, 672), five tiles, a 48 x 48 grid
        # cropped to 36 rows, 36 * 49 + 576 image tokens
        pp, gw, gh, crop = tn._pack_plan(hw, pins, cfg)
        assert (pp, gw, gh, crop) == (24, 2, 2, (6, 42, 0, 48))
        assert pp * pp + (crop[1] - crop[0]) * (crop[3] - crop[2] + 1) \
            == 2340


@pytest.mark.parametrize("hw", [(96, 128), (128, 96), (50, 50), (30, 200)])
def test_pack_anyres_features_and_twin_match_jax(hw):
    cfg = types.SimpleNamespace(image_size=28, patch_size=14)
    gw, gh = tn.anyres_grid_shape(hw, PINPOINTS, 28)
    rng = np.random.default_rng(18)
    tiles = rng.standard_normal((1 + gw * gh, 4, 8)).astype(np.float32)
    newline = rng.standard_normal(8).astype(np.float32)
    want = jn.pack_anyres_features(tiles, hw, PINPOINTS, cfg, newline)
    got = tn.pack_anyres_features(tiles, hw, PINPOINTS, cfg, newline)
    np.testing.assert_array_equal(got, want)
    twin = tn.pack_anyres_features_torch(torch.from_numpy(tiles), hw,
                                         PINPOINTS, cfg,
                                         torch.from_numpy(newline))
    np.testing.assert_array_equal(twin.numpy(), want)
    grid = rng.standard_normal((4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tn.unpad_feature_grid(grid, hw),
                                  jn.unpad_feature_grid(grid, hw))


@pytest.mark.parametrize("hw,kind", [((96, 128), "u8"), ((75, 40), "u8"),
                                     ((33, 47), "float"), ((60, 60), "grey"),
                                     ((20, 31), "u8")])
def test_preprocess_anyres_matches_jax_to_the_grey_level(hw, kind):
    """The port's own bicubic resize against the JAX package's (Pillow):
    the largest difference is 0 grey levels, on up- and downscales."""
    rng = np.random.default_rng(19)
    if kind == "u8":
        image = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    elif kind == "float":
        image = rng.random(hw + (3,)).astype(np.float32)
    else:
        image = rng.integers(0, 256, hw).astype(np.uint8)
    cfg = types.SimpleNamespace(image_size=28, patch_size=14)
    want, want_hw = jn.preprocess_anyres(image, PINPOINTS, cfg,
                                         normalize=False)
    got, got_hw = tn.preprocess_anyres(image, PINPOINTS, cfg,
                                       normalize=False)
    assert got_hw == want_hw == hw and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
    assert diff == 0, f"{diff} grey levels"
    wantn, _ = jn.preprocess_anyres(image, PINPOINTS, cfg)
    gotn, _ = tn.preprocess_anyres(image, PINPOINTS, cfg)
    np.testing.assert_allclose(gotn, wantn, rtol=0, atol=1e-6)
    dev, _ = tn.preprocess_anyres(image, PINPOINTS, cfg, device="cpu")
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), gotn)


def test_resize_bicubic_matches_pillow_on_a_production_downscale():
    from PIL import Image
    rng = np.random.default_rng(20)
    image = rng.integers(0, 256, (270, 360, 3)).astype(np.uint8)
    for oh, ow in ((84, 84), (126, 168), (270, 200), (300, 360)):
        want = np.asarray(Image.fromarray(image).resize((ow, oh),
                                                        Image.BICUBIC))
        np.testing.assert_array_equal(tn.resize_bicubic_u8(image, oh, ow),
                                      want)


def test_clip_normalize_and_preprocess_image_match_jax():
    rng = np.random.default_rng(21)
    tiles = rng.integers(0, 256, (3, 28, 28, 3)).astype(np.uint8)
    want = np.asarray(jn.clip_normalize_jnp(jnp.asarray(tiles)))
    got = tn.clip_normalize(torch.from_numpy(tiles)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.CLIP_IMAGE_MEAN, jr.CLIP_IMAGE_MEAN)
    np.testing.assert_array_equal(tr.CLIP_IMAGE_STD, jr.CLIP_IMAGE_STD)
    for image in (rng.random((40, 52, 3)).astype(np.float32),
                  rng.integers(0, 256, (31, 29)).astype(np.uint8)):
        np.testing.assert_array_equal(tr.preprocess_image(image, 28),
                                      jr.preprocess_image(image, 28))


def test_llava_next_forward_and_generate_match_jax():
    jmodel, variables, tmodel = _pair(newline=True,
                                      image_grid_pinpoints=PINPOINTS)
    rng = np.random.default_rng(22)
    image = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    tiles, hw = tn.preprocess_anyres(image, PINPOINTS, tmodel.cfg)
    n = 4 + 4 * (4 + 1)       # base + four rows of four patches and newline
    ids = np.concatenate([np.full((1, n), 100), rng.integers(
        1, 99, (1, 6))], axis=1).astype(np.int32)
    (want, _), jn_count = jn.llava_next_forward(
        jmodel, variables, jnp.asarray(ids), tiles, hw, PINPOINTS)
    (got, _), tn_count = tn.llava_next_forward(
        tmodel, torch.from_numpy(ids).long(), tiles, hw, PINPOINTS)
    assert tn_count == jn_count == n
    _close(got, want)
    jt = jn.llava_next_generate(jmodel, variables, jnp.asarray(ids), tiles,
                                hw, PINPOINTS, max_new_tokens=5)
    tt = tn.llava_next_generate(tmodel, torch.from_numpy(ids).long(), tiles,
                                hw, PINPOINTS, max_new_tokens=5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---- the scorer and the slice as a whole ----------------------------------------------

class _Tok:
    """Fixed-length stub tokenizer with an injective decode, ids folded
    from the whole prompt so that candidates differ."""

    def __init__(self, vocab=128, n=24):
        self.vocab, self.n = vocab, n

    def encode(self, text):
        data = np.frombuffer(text.encode(), np.uint8).astype(np.int64)
        fold = np.zeros(-(-len(data) // self.n) * self.n, np.int64)
        fold[:len(data)] = data
        ids = fold.reshape(-1, self.n).sum(axis=0) % (self.vocab - 40) + 3
        return [1] + ids.tolist()

    def decode(self, ids):
        key = 0
        for i in ids:
            key = (key * 1000003 + int(i) + 1) % (10 ** 9)
        return f"0.{key:09d}"


def _candidates(seed, n=5):
    rng = np.random.default_rng(seed)
    return [dict(leaf_id=i + 1, x=float(rng.integers(5, 90)),
                 y=float(rng.integers(5, 90)),
                 clutter_score=float(rng.uniform(0.2, 1)),
                 distance_score=float(rng.uniform(0.2, 1)),
                 visibility_score=float(rng.uniform(0.2, 1)),
                 geometric_score=float(rng.uniform(0.2, 1)))
            for i in range(n)]


@pytest.mark.parametrize("anyres", [False, True])
def test_scorer_scores_equal_jax_and_batched_equals_one_by_one(anyres):
    jmodel, variables, tmodel = _pair(newline=True,
                                      image_grid_pinpoints=PINPOINTS)
    jvars = jax.tree.map(jnp.asarray, variables)
    rng = np.random.default_rng(23)
    image = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    cands = _candidates(23)
    want = jr.LlavaJaxScorer(jmodel, jvars, _Tok(), max_new_tokens=6,
                             decode_mode="steps", anyres=anyres) \
        .score(image, cands, "Select the best leaf for grasping")
    scorer = tr.LlavaTorchScorer(tmodel, _Tok(), max_new_tokens=6,
                                 decode_mode="steps", anyres=anyres)
    got = scorer.score(image, cands, "Select the best leaf for grasping")
    assert got == want and len(set(got)) > 1
    batched = scorer.last["tokens"]
    assert scorer.last["n_image_tokens"] == (24 if anyres else 4)
    assert scorer.last["prompt_len"] == scorer.last["n_image_tokens"] + 25
    scorer.max_batch = 1
    assert scorer.score(image, cands, "Select the best leaf for grasping") \
        == got
    assert scorer.last["tokens"] == batched
    scorer.max_batch = 2
    assert scorer.score(image, cands, "Select the best leaf for grasping") \
        == got
    assert scorer.score(None, cands[:2], "text only") == \
        jr.LlavaJaxScorer(jmodel, jvars, _Tok(), max_new_tokens=6) \
        .score(None, cands[:2], "text only")


def test_scorer_reads_the_host_once_per_batch():
    from leafgrasp_tpu_torch.utils import device as tdevice
    _, _, tmodel = _pair(newline=True, image_grid_pinpoints=PINPOINTS)
    scorer = tr.LlavaTorchScorer(tmodel, _Tok(), max_new_tokens=4,
                                 anyres=True)
    image = np.random.default_rng(24).integers(0, 256, (60, 80, 3)) \
        .astype(np.uint8)
    tdevice.reset_host_reads()
    scorer.score(image, _candidates(24), "Select")
    assert tdevice.host_reads() == 1
    scorer.max_batch = 2
    tdevice.reset_host_reads()
    scorer.score(image, _candidates(24), "Select")
    assert tdevice.host_reads() == 3


def test_vla_service_publishes_the_same_choice_as_jax():
    """The slice as a whole at tiny widths on the CPU: both packages'
    ``GraspService(hybrid_selector=HybridGraspSelector(VLAProcessor(
    scorer)))`` on the same frames, stub tokenizer and weights, in f32:
    the same VLA choice, leaf and published message."""
    import leafgrasp_tpu.config as jcfg_mod
    import leafgrasp_tpu_torch.config as tcfg_mod
    from leafgrasp_tpu.io.scenes import make_leaf_scene
    from leafgrasp_tpu.pipeline.ingest import GraspService as JService
    from leafgrasp_tpu.vla.hybrid import HybridGraspSelector as JSelector
    from leafgrasp_tpu.vla.processor import VLAProcessor as JProcessor
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
    from leafgrasp_tpu_torch.vla.processor import VLAProcessor

    h, w = 270, 360

    def cfg(mod):
        return mod.PipelineConfig(
            frame=mod.FrameConfig(height=h, width=w, max_leaves=8),
            leaf=mod.LeafSelectionConfig(min_leaf_area=1500))

    jmodel, variables, tmodel = _pair(newline=True,
                                      image_grid_pinpoints=PINPOINTS)
    jvars = jax.tree.map(jnp.asarray, variables)
    jscorer = jr.LlavaJaxScorer(jmodel, jvars, _Tok(), max_new_tokens=6,
                                decode_mode="steps", anyres=True)
    tscorer = tr.LlavaTorchScorer(tmodel, _Tok(), max_new_tokens=6,
                                  decode_mode="steps", anyres=True)
    jm, tm = [], []
    js = JService(cfg(jcfg_mod), publish=jm.append, min_interval_s=0.0,
                  hybrid_selector=JSelector(JProcessor(jscorer)))
    ts = GraspService(cfg(tcfg_mod), publish=tm.append, min_interval_s=0.0,
                      device="cpu",
                      hybrid_selector=HybridGraspSelector(
                          VLAProcessor(tscorer)))
    rgb = np.random.default_rng(25).integers(0, 256, (h, w, 3)) \
        .astype(np.uint8)
    js.on_rgb(rgb)
    ts.on_rgb(rgb)
    frames = [make_leaf_scene(height=h, width=w, num_leaves=4, seed=3,
                              margin=40),
              make_leaf_scene(height=h, width=w, num_leaves=5, seed=11,
                              margin=40)]
    reselected = 0
    for i, (mask, depth) in enumerate(frames):
        for svc in (js, ts):
            svc.on_mask(mask, stamp_us=i)
            svc.on_depth(depth, stamp_us=i)
        a = js.process_pending(force=True)
        b = ts.process_pending(force=True)
        assert b["found"] and b["vla"] is not None and a["vla"] is not None
        assert b["vla"]["leaf_id"] == a["vla"]["leaf_id"]
        assert b["vla"]["strategy"] == a["vla"]["strategy"]
        assert abs(b["vla"]["vla_confidence"]
                   - a["vla"]["vla_confidence"]) <= 1e-6
        assert abs(b["vla"]["hybrid_score"] - a["vla"]["hybrid_score"]) \
            <= 1e-6
        assert int(b["result"].leaf_id) == int(a["result"].leaf_id)
        pa, pb = a["message"].split(","), b["message"].split(",")
        assert pa[:2] == pb[:2]
        np.testing.assert_allclose([float(x) for x in pb[2:]],
                                   [float(x) for x in pa[2:]], rtol=0,
                                   atol=1e-4)
        reselected += "vla_reselect" in ts.stats()["stages"]
    assert len(tm) == len(jm) == len(frames)
    assert tscorer.last["n_image_tokens"] > 4


def test_greedy_generate_records_its_prefill_and_decode_spans():
    from leafgrasp_tpu_torch.utils.profiler import StageTimer
    tcfg = tl.LlavaTorchConfig(**TINY)
    model = tl.LlavaTorch(tcfg, device="cpu")
    ids, px = _inputs(5, b=2, t=9)
    feats = model.vision_project(torch.from_numpy(px[:1]))
    feats = feats.expand(2, *feats.shape[1:])
    timer = StageTimer()
    with timer.bound():
        for _ in range(2):
            tl.greedy_generate_llava(model, torch.from_numpy(ids).long(),
                                     image_features=feats, max_new_tokens=4)
    tl.greedy_generate_llava(model, torch.from_numpy(ids).long(),
                             image_features=feats, max_new_tokens=4)
    st = timer.summary()
    assert st["vla_prefill"]["count"] == st["vla_decode"]["count"] == 2


def _random_model(seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    model = tl.LlavaTorch(tl.LlavaTorchConfig(**{**TINY, **kw}),
                          device="cpu")
    return tl.init_random_(model, gen, std=0.1)


def test_decode_at_a_rounded_capacity_gives_the_exact_lengths_tokens():
    """The graph route's cache capacity (prompt and new tokens rounded
    up to ``CACHE_QUANTUM``), run uncaptured on the CPU: the prompt pass
    into the longer caches and the steps, with the prompt length on the
    device, give ``greedy_generate_llava``'s tokens at the exact length.
    The slots past the prompt are masked, so they may hold anything
    finite."""
    model = _random_model(1)
    ids, px = _inputs(12, b=3, t=13)
    ids = torch.from_numpy(ids).long()
    pad = torch.tensor([0, 3, 6], dtype=torch.int32)
    feats = model.vision_project(torch.from_numpy(px[:1]))
    feats = feats.expand(3, *feats.shape[1:])
    want = tl.greedy_generate_llava(model, ids, image_features=feats,
                                    max_new_tokens=6, pad_lens=pad)
    cap = tl.CACHE_QUANTUM
    assert cap > 13 + 6
    cache = KVCache(model.cfg, 3, cap, ids.device)
    with torch.no_grad():
        for i in range(model.cfg.layers):
            ck, cv = cache.layers[i]
            ck[:, 13:].fill_(7.0)
            cv[:, 13:].fill_(-3.0)
        first, _ = tl._generate_prefill(model, ids, pad, None, feats, cache)
        steps = tl._decode_steps(model, cache, first, pad,
                                 torch.full((), 13, dtype=torch.int64), 5)
    got = torch.cat([first[:, None], steps], dim=1).to(torch.int32)
    assert len(set(map(tuple, want.tolist()))) > 1
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _step_logits(model, ids, pad):
    """One decode step after the prompt pass into caches of 4 more
    slots: its logits and the caches."""
    from leafgrasp_tpu_torch.kernels.decode_attention import slot_mask
    from leafgrasp_tpu_torch.vla.layers import STEP
    b, t = ids.shape
    cache = KVCache(model.cfg, b, t + 4, "cpu")
    with torch.no_grad():
        first, _ = tl._generate_prefill(model, ids, pad, None, None, cache)
        slot = torch.tensor([t])
        step = Pass(STEP, slot_mask(slot, torch.arange(t + 4), pad,
                                    model.cfg.sliding_window),
                    pad, cursor=slot, cache=cache)
        x = model.decoder(model.embed(first[:, None]),
                          (torch.tensor(t) - pad)[:, None], step)
        return model.head(x), cache.data, step.attended


@pytest.mark.parametrize("kw,param_dtype", [
    ({}, torch.float32),
    ({"dtype": "bfloat16"}, torch.bfloat16),
    ({"dtype": "bfloat16"}, torch.float32),  # f32 layer input, bf16 cache
    ({"sliding_window": 6}, torch.float32),
])
def test_decode_step_route_equals_the_dense_masked_step(monkeypatch, kw,
                                                        param_dtype):
    """A step of the grouped-query decoder takes
    ``kernels/decode_attention`` (``Pass.decode_kernel``); on CPU tensors
    its plain version gives the dense masked step's logits, caches and
    greedy tokens bit for bit (the dense step is the route the step took
    before the kernel, here with ``Pass.decode_kernel`` off), and the
    step's pass, ``timings`` and the scorer say "plain" where the steps
    took it, and nothing where they did not."""
    gen = torch.Generator().manual_seed(21)
    model = tl.init_random_(tl.LlavaTorch(tl.LlavaTorchConfig(**{**TINY,
                                                                 **kw}),
                                          device="cpu",
                                          param_dtype=param_dtype),
                            gen, std=0.2)
    ids, _ = _inputs(22, b=3, t=13)
    ids = torch.from_numpy(ids).long()
    pad = torch.tensor([0, 4, 9], dtype=torch.int32)
    ids[torch.arange(13)[None, :] < pad[:, None]] = 0
    logits, caches, attended = _step_logits(model, ids, pad)
    assert attended == {"plain"}
    timings = {}
    got = tl.greedy_generate_llava(model, ids, max_new_tokens=7,
                                   pad_lens=pad, timings=timings)
    assert timings["decode_attention"] == "plain"
    calls = []
    monkeypatch.setattr(tl._da, "decode_attention",
                        lambda *a: calls.append(1))
    monkeypatch.setattr(Pass, "decode_kernel", lambda self: False)
    want_logits, want_caches, attended = _step_logits(model, ids, pad)
    timings = {}
    want = tl.greedy_generate_llava(model, ids, max_new_tokens=7,
                                    pad_lens=pad, timings=timings)
    assert calls == [] and not attended
    assert "decode_attention" not in timings
    assert torch.equal(logits, want_logits)
    assert torch.equal(caches, want_caches)
    assert torch.equal(got, want)
    assert len(set(map(tuple, got.tolist()))) > 1


def test_scorer_keeps_the_decode_attention_route():
    """``LlavaTorchScorer.last["decode_attention"]`` reads the steps'
    route ("plain" on the CPU); a rerank of one new token has no step and
    keeps none."""
    class Tok:
        def encode(self, text):
            return [1 + len(text) % 7] + [3 + ord(ch) % 90
                                          for ch in text[:8]]

        def decode(self, ids):
            return "0." + "".join(str(int(i) % 10) for i in ids)

    cands = [dict(leaf_id=i + 1, x=float(10 + 7 * i), y=float(30 - 3 * i),
                  clutter_score=0.2 + 0.1 * i, distance_score=0.9 - 0.1 * i,
                  geometric_score=0.5 + 0.05 * i) for i in range(3)]
    scorer = tr.LlavaTorchScorer(_random_model(23), Tok(), max_new_tokens=3)
    scorer.score(None, cands, "Select")
    assert scorer.last["decode_attention"] == "plain"
    scorer.max_new_tokens = 1
    scorer.score(None, cands, "Select")
    assert "decode_attention" not in scorer.last


def test_decode_stays_eager_off_the_card_and_under_tensor_parallel():
    """The route follows what the call observes: a CPU device, or a
    tensor-parallel projection anywhere in the model (a capture cannot
    hold its collectives), keeps the eager loop, and the scorer says
    so in ``last``."""
    from leafgrasp_tpu_torch.parallel.sharding import ColumnParallel
    model = _random_model(2, image_grid_pinpoints=PINPOINTS)
    assert tl._decode_graphs(model, torch.device("cpu")) is None
    scorer = tr.LlavaTorchScorer(model, _Tok(), max_new_tokens=4,
                                 anyres=True)
    image = np.random.default_rng(25).integers(0, 256, (60, 80, 3)) \
        .astype(np.uint8)
    scorer.score(image, _candidates(25), "Select")
    assert scorer.last["decode_graph"] == "eager"
    scorer.max_batch = 2
    scorer.score(image, _candidates(25), "Select")
    assert scorer.last["decode_graph"] == "eager"
    attn = model.layers[1].self_attn
    attn.q_proj = ColumnParallel(attn.q_proj, axis=None)
    assert tl._decode_graphs(model, torch.device("cuda")) is None


# ---- the shared image prefix (greedy_generate_llava's shared route) ------------------

def _shared_rows(seed, n, texts, vocab=99):
    """Rows of ``n`` image tokens then text of the given lengths, left
    padded to one length: (ids, pads)."""
    rng = np.random.default_rng(seed)
    t = n + max(texts)
    ids = np.zeros((len(texts), t), np.int64)
    pads = []
    for r, m in enumerate(texts):
        p = t - n - m
        ids[r, p:p + n] = TINY["image_token_index"]
        ids[r, p + n:] = rng.integers(1, vocab, m)
        pads.append(p)
    return torch.from_numpy(ids), pads


def _generate_with_first_logits(model, ids, feats, pads, n_new=6):
    """(tokens, the last lm_head call's logits, timings)."""
    seen = []
    hook = model.lm_head.register_forward_hook(
        lambda _m, _a, out: seen.append(out.detach().clone()))
    timings = {}
    try:
        toks = tl.greedy_generate_llava(model, ids, image_features=feats,
                                        max_new_tokens=n_new,
                                        pad_lens=pads, timings=timings)
    finally:
        hook.remove()
    first = [x for x in seen if x.shape[0] == ids.shape[0]][0]
    return toks, first[:, -1], timings


@pytest.mark.parametrize("features", ["single_tile", "anyres", "long"])
@pytest.mark.parametrize("texts", [(25, 25, 25), (25, 18, 30), (9, 3, 21)])
def test_shared_prefix_route_equals_the_single_pass(features, texts):
    """Features of one image, (1, N, hidden), under several rows: the
    prefix runs once, its K/V go into every row and the rows' text runs
    over them. The first logits (f32) within 1e-4 of the single pass
    over every row with the features repeated, the tokens equal; rows of
    equal length and of unequal length, including a pad past N;
    single-tile, anyres and a long prefix (130 tokens, the flash route's
    plain version in both attentions). The two prompt passes' caches
    agree to the same tolerance in every slot from each row's pad."""
    kw = dict(image_grid_pinpoints=PINPOINTS) if features == "anyres" \
        else dict(prefill_attn_impl="flash", prefill_attn_chunk=64) \
        if features == "long" else {}
    model = _random_model(7, **kw)
    with torch.no_grad():
        if features == "anyres":
            image = np.random.default_rng(8).integers(
                0, 256, (96, 128, 3)).astype(np.uint8)
            feats, _ = tr.LlavaTorchScorer(model, _Tok(), anyres=True) \
                ._encode_image(image)
        elif features == "single_tile":
            feats = model.vision_project(torch.from_numpy(
                _inputs(8)[1][:1]))
        else:
            feats = torch.from_numpy(np.random.default_rng(8)
                                     .standard_normal((1, 130, 64))
                                     .astype(np.float32))
    n = feats.shape[1]
    ids, pads = _shared_rows(9, n, texts)
    if features == "single_tile" and texts == (9, 3, 21):
        assert max(pads) > n
    got, got_first, got_t = _generate_with_first_logits(model, ids, feats,
                                                        pads)
    want, want_first, want_t = _generate_with_first_logits(
        model, ids, feats.expand(len(texts), -1, -1), pads)
    assert (got_t["prefill_route"], want_t["prefill_route"]) \
        == ("shared", "full")
    np.testing.assert_allclose(got_first.numpy(), want_first.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, want)
    assert len(set(map(tuple, want.tolist()))) > 1
    b, t = ids.shape
    shared, full = (KVCache(model.cfg, b, t + 6, ids.device) for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32)
    with torch.no_grad():
        tl._generate_prefill_shared(model, ids, pad, pads, feats, shared)
        tl._generate_prefill(model, ids, pad, None, feats.expand(b, -1, -1),
                             full)
    for r, p in enumerate(pads):                 # (layers, 2, rows, ...)
        np.testing.assert_allclose(shared.data[:, :, r, p:].numpy(),
                                   full.data[:, :, r, p:].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_shared_prefix_route_runs_both_attentions_through_the_flash_route(
        monkeypatch):
    """On the flash route each layer of the shared pass calls the
    kernel's wrapper for the prefix (one row, no offset) and for the
    rows' text (a query offset of N); every slot before a row's pad
    stays as the store held it (zero), every slot from it is written."""
    model = _random_model(10, prefill_attn_impl="flash")
    feats = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 130, 64)).astype(np.float32))
    ids, pads = _shared_rows(12, 130, (20, 7, 14))
    calls = []
    real = tl._fp.flash_prefill
    monkeypatch.setattr(
        tl._fp, "flash_prefill",
        lambda q, k, v, pad, o=0: calls.append((q.shape[:2], o))
        or real(q, k, v, pad, o))
    cache = KVCache(model.cfg, 3, 160, ids.device)
    cache.data.fill_(5.0)
    cache.zero_(0, max(pads))
    with torch.no_grad():
        tl._generate_prefill_shared(model, ids, torch.tensor(
            pads, dtype=torch.int32), pads, feats, cache)
    t = ids.shape[1]
    layers = model.cfg.layers
    assert calls == [((1, 130), 0), ((3, t - 130), 130)] * layers
    kv = cache.data                              # (layers, 2, rows, ...)
    for r, p in enumerate(pads):
        assert not kv[:, :, r, :p].any()
        assert kv[:, :, r, p:t].abs().amin() > 0


def test_prefill_route_is_full_without_features_shared_by_rows():
    """One row, no image, and features of every row keep the single pass
    over every slot; the scorer reports the newest batch's route."""
    model = _random_model(13, image_grid_pinpoints=PINPOINTS)
    feats = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 6, 64)).astype(np.float32))
    ids, pads = _shared_rows(15, 6, (5, 9))
    for kw, rows in ((dict(image_features=feats), 1),
                     (dict(image_features=feats.expand(2, -1, -1)), 2),
                     (dict(image_features=feats[0]), 1),
                     ({}, 2)):
        timings = {}
        tl.greedy_generate_llava(model, ids[:rows], max_new_tokens=3,
                                 pad_lens=pads[:rows], timings=timings, **kw)
        assert timings["prefill_route"] == "full", (kw, rows)
    scorer = tr.LlavaTorchScorer(model, _Tok(), max_new_tokens=4,
                                 anyres=True)
    image = np.random.default_rng(16).integers(0, 256, (60, 80, 3)) \
        .astype(np.uint8)
    scorer.score(image, _candidates(16), "Select")
    assert scorer.last["prefill_route"] == "shared"
    scorer.max_batch = 1
    scorer.score(image, _candidates(16), "Select")
    assert scorer.last["prefill_route"] == "full"
    scorer.max_batch = None
    scorer.score(None, _candidates(16), "Select")
    assert scorer.last["prefill_route"] == "full"

    class ImageIdTok(_Tok):
        """Text ids that include the image token's: such a row holds
        more image tokens than the image has features."""

        def encode(self, text):
            return super().encode(text)[:-1] + [TINY["image_token_index"]]

    scorer.tokenizer = ImageIdTok()
    scorer.score(image, _candidates(16), "Select")
    assert scorer.last["prefill_route"] == "full"
