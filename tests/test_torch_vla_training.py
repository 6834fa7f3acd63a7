"""The port's VLA training against the JAX package's, on the CPU at tiny
widths: the flash prefill's backward, LoRA dropout, the TinyVLA and
LLaVA trainers, their adapter files and the sweep.

Tolerances, each with its reason:
- the plain backward of the flash prefill against the Pallas library's
  reference VJP ``mha_reference_bwd`` (the math its two backward kernels
  compute) and against torch autograd of the plain forward: 1e-5 of each
  gradient's L2 norm (f32 sums in other orders);
- a LLaVA training step: the loss to 1e-5 relative; each adapter's
  gradient and updated value as close to the float64 value (the port's
  model in double precision, and optax's first AdamW step in double) as
  JAX's own f32 value is, within a factor 2 plus 1e-5 of the gradient's
  norm, as the CNN's training step is held, or for an updated value plus
  two f32 ulps of the leaf's largest value (torch's AdamW decays, then
  steps: two roundings where optax has one); frozen leaves bit-equal;
- the TinyVLA trainer's loss history over two epochs at
  ``lora_dropout=0``: 1e-4 relative (AdamW steps on f32 gradients that
  differ in their last bits, compounded over six steps);
- evaluation of the shipped sweep adapter: top-1 and Spearman equal
  (parsed decimals of greedy tokens);
- LLaVA logits from an adapter file written by the other package: 1e-4
  relative and 3e-5 absolute (logits up to about 4 in size; f32 sums in
  other orders in the two frameworks).
"""

import dataclasses
import functools
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.traverse_util as tu
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from leafgrasp_tpu.vla import llava_jax as jl
from leafgrasp_tpu.vla import lm as jlm
from leafgrasp_tpu.vla import trainer as jtr
from leafgrasp_tpu.vla.llava_trainer import LlavaLoRATrainer as JTrainer
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.kernels import flash_prefill as tfp
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import experiments as texp
from leafgrasp_tpu_torch.vla import llava_torch as tl
from leafgrasp_tpu_torch.vla.layers import FLASH_MIN_TOKENS
from leafgrasp_tpu_torch.vla import lora as tlora
from leafgrasp_tpu_torch.vla import trainer as ttr
from leafgrasp_tpu_torch.vla.llava_trainer import LlavaLoRATrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts", "vla")
REL = 1e-5

TINY = dict(vis_hidden=32, vis_intermediate=64, vis_layers=2, vis_heads=2,
            image_size=28, patch_size=14, vocab_size=128, hidden=64,
            intermediate=96, layers=2, heads=4, kv_heads=2,
            image_token_index=100, lora_rank=4, lora_alpha=8.0)


class Tok:
    """The JAX package's test tokenizer (tests/test_llava_jax.py),
    keeping ``n`` ids of the prompt's bytes."""

    def __init__(self, n=60):
        self.n = n

    def encode(self, text):
        return [1] + [b % 90 + 2 for b in text.encode()][:self.n]

    def decode(self, ids):
        return "0.5"


def _jax_init_vla(seed, cfg):
    """``leafgrasp_tpu.vla.lm.init_vla``'s variables, initialized under
    ``jit`` (the same values, in a fraction of the eager time)."""
    model = jlm.TinyVLA(cfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    image = jnp.zeros((1, cfg.vision_patch, cfg.vision_patch, 3),
                      jnp.float32)
    return jax.jit(lambda key: model.init(key, tokens, image=image,
                                          train=False))(
        jax.random.PRNGKey(seed))


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.linalg.norm(want),
                                                 1e-30))


# ---- the flash prefill's backward ------------------------------------------------

def _attn_inputs(seed, b=2, t=40, heads=4, kvh=2, hd=16, pads=(0, 7)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, heads, hd)).astype(np.float32)
    k = rng.standard_normal((b, t + 3, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t + 3, kvh, hd)).astype(np.float32)
    dout = rng.standard_normal((b, t, heads, hd)).astype(np.float32)
    for i, p in enumerate(pads):
        dout[i, :p] = 0.0      # pad rows: the port outputs constant zeros
    return q, k, v, np.asarray(pads, np.int32), dout


@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_plain_backward_matches_the_pallas_reference_vjp(kvh):
    """``flash_prefill_backward_plain`` against ``mha_reference_bwd`` of
    the Pallas TPU flash attention, given q * scale and sm_scale 1.0
    (which it requires), its own residuals l and m, K/V repeated to the
    query heads (so the port's dK and dV are the reference's summed over
    each group), causal with segment ids for the left pads (pad rows in
    segment 0, real rows in 1): 1e-5 of each gradient's norm; the
    forward's output and log-sum-exp too."""
    q, k, v, pad, dout = _attn_inputs(1, kvh=kvh)
    b, t, heads, hd = q.shape
    rep = heads // kvh
    scale = 1.0 / np.sqrt(hd)
    seg = (np.arange(t)[None, :] >= pad[:, None]).astype(np.int32)
    segs = pallas_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))

    def heads_first(a):
        return jnp.asarray(np.moveaxis(a, 1, 2))

    qj = heads_first(q * scale)
    kj = heads_first(np.repeat(k[:, :t], rep, axis=2))
    vj = heads_first(np.repeat(v[:, :t], rep, axis=2))
    out_j, l_j, m_j = pallas_fa.mha_reference_no_custom_vjp(
        qj, kj, vj, None, segs, causal=True, sm_scale=1.0,
        save_residuals=True)
    dq_j, dk_j, dv_j, _ = pallas_fa.mha_reference_bwd(
        qj, kj, vj, None, segs, out_j, l_j, m_j, heads_first(dout),
        causal=True, sm_scale=1.0)

    tq, tk, tv, tpad = (torch.from_numpy(a) for a in (q, k, v, pad))
    out, lse = tfp.flash_prefill_plain(tq, tk, tv, tpad, return_lse=True)
    dq, dk, dv = tfp.flash_prefill_backward_plain(
        tq, tk, tv, tpad, out, lse, torch.from_numpy(dout), chunk=16)

    def group_sum(g):                      # (b, heads, t, hd) -> k's shape
        g = np.moveaxis(np.asarray(g), 1, 2).reshape(b, t, kvh, rep, hd)
        return np.concatenate([g.sum(3), np.zeros((b, 3, kvh, hd))], 1)

    real = np.arange(t)[None, :] >= pad[:, None]
    out_ref = np.moveaxis(np.asarray(out_j), 1, 2)
    assert _rel_err(out.numpy()[real], out_ref[real]) <= REL
    lse_ref = np.asarray(m_j + jnp.log(l_j))          # natural log
    assert np.all(np.isneginf(lse.numpy()[~real[:, None, :]
                                          .repeat(heads, 1)]))
    live = np.broadcast_to(real[:, None, :], lse_ref.shape)
    assert _rel_err(lse.numpy()[live], lse_ref[live]) <= REL
    assert _rel_err(dq.numpy(), scale * np.moveaxis(np.asarray(dq_j), 1, 2)) \
        <= REL
    assert _rel_err(dk.numpy(), group_sum(dk_j)) <= REL
    assert _rel_err(dv.numpy(), group_sum(dv_j)) <= REL
    assert not dk[:, t:].any() and not dv[:, t:].any()


def test_plain_backward_matches_torch_autograd_of_the_plain_forward():
    """The explicit formulas against autograd of ``flash_prefill_plain``
    in float64 (1e-5 of each norm), and ``FlashPrefill`` on CPU tensors
    (whose backward is the plain version) in f32 against the same."""
    q, k, v, pad, dout = _attn_inputs(2, t=37, pads=(0, 9))
    tq, tk, tv = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    tpad, tdout = torch.from_numpy(pad), torch.from_numpy(dout)
    tfp.flash_prefill_plain(tq, tk, tv, tpad).backward(tdout.double())
    exact = (tq.grad, tk.grad, tv.grad)
    out, lse = tfp.flash_prefill_plain(*(x.detach() for x in (tq, tk, tv)),
                                       tpad, return_lse=True)
    plain = tfp.flash_prefill_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), tpad, out, lse, tdout,
        chunk=10)
    fq, fk, fv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfp.flash_prefill_trainable(fq, fk, fv, tpad)
    assert o.grad_fn is not None and "FlashPrefill" in type(o.grad_fn).__name__
    o.backward(tdout)
    for g, p, e in zip((fq.grad, fk.grad, fv.grad), plain, exact):
        assert g.dtype == torch.float32
        assert _rel_err(p.numpy(), e.numpy()) <= REL
        assert _rel_err(g.numpy(), e.numpy()) <= REL
    with torch.no_grad():
        served = tfp.flash_prefill_trainable(fq, fk, fv, tpad)
    assert served.grad_fn is None


def _count_flash_function(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = tfp.FlashPrefill.forward, tfp.FlashPrefill.backward

    def forward(ctx, *a):
        calls["forward"] += 1
        return fwd(ctx, *a)

    def backward(ctx, *a):
        calls["backward"] += 1
        return bwd(ctx, *a)

    monkeypatch.setattr(tfp.FlashPrefill, "forward", staticmethod(forward))
    monkeypatch.setattr(tfp.FlashPrefill, "backward", staticmethod(backward))
    return calls


def test_flash_route_gradients_equal_the_chunked_routes_on_cpu(monkeypatch):
    """A tiny LoRA ``LlavaTorch`` differentiated through the flash route
    (``FlashPrefill``, once a layer each way) and through the chunked
    route: every parameter's gradient within 1e-5 of its norm, the q/k/v
    adapters' among them."""
    calls = _count_flash_function(monkeypatch)
    cfg = tl.LlavaTorchConfig(**{**TINY, "prefill_attn_impl": "flash"})
    model = tl.LlavaTorch(cfg, device="cpu")
    tl.init_random_(model, torch.Generator().manual_seed(0), std=0.1)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 99, (2, 140)))
    grads = {}
    for route in ("flash", "chunked"):
        model.set_prefill_attn(route, chunk=48)
        model.zero_grad(set_to_none=True)
        logits, _ = model(ids)
        torch.log_softmax(logits, -1)[..., 5].mean().backward()
        grads[route] = {n: p.grad for n, p in model.named_parameters()
                        if p.grad is not None}
    assert calls == {"forward": cfg.layers, "backward": cfg.layers}
    assert "layers.0.self_attn.k_proj.lora_b" in grads["flash"]
    assert set(grads["flash"]) == set(grads["chunked"])
    for name, g in grads["flash"].items():
        assert _rel_err(g.numpy(), grads["chunked"][name].numpy()) <= REL, \
            name


# ---- LoRA dropout and the state_dict helpers ------------------------------------

def test_lora_dropout_on_the_adapter_input_only():
    """Flax's dropout semantics: in training mode, the adapter's input
    only (the base path sees x); kept with 1 - p and scaled by
    1 / (1 - p); the masks from the module's generator (the same seed,
    the same masks); none in eval mode, none in training mode where the
    module is built without it (as ``LlavaTorch`` builds its adapters)."""
    p = 0.25
    layer = tlora.LoRADense(64, 8, rank=4, alpha=8.0, dropout=p)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in layer.parameters():
            prm.normal_(generator=gen)
    x = torch.randn((256, 64), generator=gen)
    tlora.set_dropout_generator(layer, torch.Generator().manual_seed(5))
    layer.train()
    with torch.no_grad():
        y = layer(x)
        keep = torch.rand(x.shape, generator=torch.Generator()
                          .manual_seed(5)) < 1 - p
        h = torch.where(keep, x / (1 - p), torch.zeros_like(x))
        want = x @ layer.base.weight.T \
            + 2.0 * (h @ layer.lora_a) @ layer.lora_b
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        assert abs(float(keep.float().mean()) - (1 - p)) < 0.01
        tlora.set_dropout_generator(layer, torch.Generator().manual_seed(5))
        assert torch.equal(layer(x), y)
        clean = layer.eval()(x)
        assert not torch.allclose(clean, y)
        torch.testing.assert_close(
            clean, x @ layer.base.weight.T
            + 2.0 * (x @ layer.lora_a) @ layer.lora_b, rtol=1e-5, atol=1e-5)
    off = tlora.LoRADense(64, 8, rank=4, alpha=8.0, dropout=p,
                          dropout_in_training=False)
    off.load_state_dict(layer.state_dict())
    with torch.no_grad():
        assert torch.equal(off.train()(x), layer.eval()(x))
    model = tl.LlavaTorch(tl.LlavaTorchConfig(**{**TINY,
                                                 "lora_dropout": 0.5}),
                          device="cpu")
    assert all(not m.dropout_in_training for m in model.modules()
               if isinstance(m, tlora.LoRADense))


def test_lora_state_helpers_match_jax():
    """``lora_mask``, ``extract_lora_params`` and ``graft_base_params`` on
    ``state_dict``s pick and carry the leaves the JAX functions pick on
    the same TinyVLA's pytree."""
    from leafgrasp_tpu.vla import lora as jlora
    cfg = jlm.VLAModelConfig(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                             mlp_hidden=64, vision_tokens=2,
                             vision_patch=16, lora_rank=2)
    jvars = _jax_init_vla(0, cfg)
    jplain = _jax_init_vla(1, dataclasses.replace(cfg, lora_rank=0))
    flat = {"/".join(k): v for k, v in tu.flatten_dict(
        jlora.lora_mask(jvars["params"])).items()}
    state = convert.flax_to_torch_tiny_vla(jvars)
    mask = tlora.lora_mask(state)
    assert sum(mask.values()) == sum(flat.values()) == 14
    back = convert.torch_to_flax_tiny_vla(
        {k: v for k, v in state.items() if mask[k]})
    assert sorted(back) == sorted(k for k, m in flat.items() if m)
    assert set(tlora.extract_lora_params(state)) == \
        {k for k, m in mask.items() if m}
    want = jlora.graft_base_params(jvars["params"], jplain["params"])
    got = tlora.graft_base_params(state,
                                  convert.flax_to_torch_tiny_vla(jplain))
    want_t = convert.flax_to_torch_tiny_vla(want)
    assert set(got) == set(want_t)
    assert all(torch.equal(got[k], want_t[k]) for k in got)
    with pytest.raises(KeyError):
        tlora.graft_base_params(state, {})


def test_torch_to_flax_round_trips_every_tinyvla_leaf():
    cfg = jlm.VLAModelConfig(dim=32, n_layers=2, n_heads=2, n_kv_heads=1,
                             mlp_hidden=64, vision_tokens=2,
                             vision_patch=16, lora_rank=3)
    jvars = _jax_init_vla(2, cfg)
    want = {"/".join(k): np.asarray(v)
            for k, v in tu.flatten_dict(jvars["params"]).items()}
    got = convert.torch_to_flax_tiny_vla(
        convert.flax_to_torch_tiny_vla(jvars))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(KeyError):
        convert.torch_to_flax_tiny_vla({"mystery.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        convert.torch_to_flax_llava_adapter({"norm.weight": torch.zeros(1)})


# ---- data helpers ------------------------------------------------------------------

def test_dataset_and_ranking_helpers_equal_jax():
    for kw in (dict(num_samples=3, seed=0), dict(num_samples=2, seed=5,
                                                  num_candidates=4,
                                                  image_size=28)):
        want = jtr.make_synthetic_vla_dataset(**kw)
        got = ttr.make_synthetic_vla_dataset(**kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g["image"], w["image"])
            assert g["candidates"] == w["candidates"]
            assert g["ranking"] == w["ranking"]
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b = rng.random(6), rng.random(6)
        assert ttr.spearman_correlation(a, b) == \
            jtr.spearman_correlation(a, b)
    assert ttr.spearman_correlation([5.0], [1.0]) == 0.0 == \
        jtr.spearman_correlation([5.0], [1.0])
    assert ttr.ranking_to_targets([2, 0, 1, 3]) == \
        jtr.ranking_to_targets([2, 0, 1, 3])
    img = rng.random((30, 50)).astype(np.float32)
    assert np.array_equal(ttr._resize(img, 16), jtr._resize(img, 16))


# ---- the LLaVA trainer ---------------------------------------------------------------

def _llava_pair(seed=0):
    """LlavaJax and LlavaTorch with the same noisy weights (adapters
    included, so that every adapter leaf has a gradient)."""
    jcfg = jl.LlavaJaxConfig(**TINY)
    jmodel = jl.LlavaJax(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    px = jnp.zeros((1, 28, 28, 3), jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, ids, pixel_values=px))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
        .astype(np.float32), variables)
    tcfg = tl.LlavaTorchConfig(**{**TINY, "prefill_attn_impl": "flash"})
    tmodel = tl.LlavaTorch(tcfg, device="cpu")
    tmodel.load_state_dict(convert.flax_to_torch_llava(variables))
    return jmodel, variables, tmodel


@functools.partial(jax.jit, static_argnums=0)
def _jax_loss_and_grads(jmodel, params, toks, lmask, imgs):
    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p}, toks[:, :-1],
                                 pixel_values=imgs)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, toks[:, 1:, None], axis=-1)[..., 0]
        lm = lmask[:, 1:]
        return jnp.sum(nll * lm) / jnp.maximum(jnp.sum(lm), 1.0)
    return jax.value_and_grad(loss_fn)(params)


def test_llava_lora_step_matches_jax():
    """One ``LlavaLoRATrainer`` step (a batch of two examples whose
    prompts pass 128 tokens, so the port's flash route runs, through
    ``FlashPrefill``) against the JAX trainer's (its loss and gradient,
    chunked route on the CPU, and its optimizer, optax's ``adamw`` under
    ``multi_transform`` with ``set_to_zero``): the loss to 1e-5
    relative; each adapter gradient and its updated value as close to
    the float64 value as JAX's; the frozen leaves unchanged; the vision
    tower outside the graph."""
    import optax
    from leafgrasp_tpu.vla.lora import lora_mask
    jmodel, variables, tmodel = _llava_pair()
    tok = Tok(n=150)
    samples = ttr.make_synthetic_vla_dataset(1, seed=0, num_candidates=2,
                                             image_size=28)
    lr = 1e-3
    jt = JTrainer(jmodel, variables, tok, learning_rate=lr, max_len=256)
    tt = LlavaLoRATrainer(tmodel, tok, learning_rate=lr, max_len=256,
                          device="cpu")
    targets = ttr.ranking_to_targets(samples[0]["ranking"])
    ex_j = [jt._example(samples[0], i, y) for i, y in targets.items()]
    ex_t = tt.examples(samples)
    for a, b in zip(ex_j, ex_t):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    pad_to = max(len(e[0]) for e in ex_t) + 1
    assert pad_to - 1 >= FLASH_MIN_TOKENS
    toks_j, lmask_j, imgs_j = jt._pad_batch(ex_j, pad_to)
    toks, lmask, imgs = tt._pad_batch(ex_t, pad_to)
    assert np.array_equal(np.asarray(toks_j), toks.numpy())
    np.testing.assert_allclose(np.asarray(imgs_j), imgs.numpy(), rtol=0,
                               atol=1e-6)

    loss_j, grads_tree = _jax_loss_and_grads(jmodel, variables["params"],
                                             toks_j, lmask_j, imgs_j)
    grads_j = convert.flax_to_torch_llava({"params": grads_tree})
    model64 = tl.LlavaTorch(tl.LlavaTorchConfig(**TINY), device="cpu")
    model64.load_state_dict(tmodel.state_dict())
    model64.double()
    tr64 = LlavaLoRATrainer(model64, tok, device="cpu")
    ttr.set_trainable(model64, full=False)
    tr64.loss(toks, lmask.double(), imgs.double()).backward()
    exact = {k: p.grad for k, p in model64.named_parameters()
             if p.grad is not None}

    calls = {"n": 0}
    fwd = tfp.FlashPrefill.forward

    def counted(ctx, *a):
        calls["n"] += 1
        return fwd(ctx, *a)

    tfp.FlashPrefill.forward = staticmethod(counted)
    try:
        ttr.set_trainable(tmodel, full=False)
        tmodel.train()
        loss = tt.loss(toks, lmask, imgs)
        loss.backward()
    finally:
        tfp.FlashPrefill.forward = staticmethod(fwd)
    assert calls["n"] == TINY["layers"]
    assert abs(float(loss.detach()) - float(loss_j)) \
        <= 1e-5 * abs(float(loss_j))
    grads_t = {k: p.grad for k, p in tmodel.named_parameters()
               if p.grad is not None}
    assert set(grads_t) == set(exact) == \
        {k for k in grads_t if k.endswith(("lora_a", "lora_b"))}
    assert len(grads_t) == 2 * 7 * TINY["layers"]
    for k, e in exact.items():
        e = e.numpy()
        err = np.abs(grads_t[k].numpy() - e).max()
        err_j = np.abs(grads_j[k].numpy() - e).max()
        assert err <= 2 * err_j + 1e-5 * np.linalg.norm(e), k

    # the step itself: one batch, one epoch of the port's trainer; JAX's
    # update is the JAX trainer's optimizer applied to its gradient
    labels = jax.tree.map(lambda m: "lora" if m else "frozen",
                          lora_mask(variables["params"]))
    tx = optax.multi_transform({"lora": optax.adamw(lr),
                                "frozen": optax.set_to_zero()}, labels)
    updates, _ = tx.update(grads_tree, tx.init(variables["params"]),
                           variables["params"])
    after_j = convert.flax_to_torch_llava(
        {"params": optax.apply_updates(variables["params"], updates)})
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.zero_grad(set_to_none=True)
    hist_t = tt.fine_tune(samples, epochs=1, batch_size=2)
    assert abs(hist_t["final_loss"] - float(loss_j)) \
        <= 1e-5 * abs(float(loss_j))
    after_t = tmodel.state_dict()
    for k, p0 in before.items():
        if k not in exact:
            assert torch.equal(after_t[k], p0), k
            continue
        g = exact[k].numpy()
        p = p0.double().numpy()
        want = p - lr * (g / (np.abs(g) + 1e-8) + 1e-4 * p)
        err = np.abs(after_t[k].numpy() - want).max()
        err_j = np.abs(after_j[k].numpy() - want).max()
        ulp = np.spacing(np.float32(np.abs(p).max()))
        assert err <= 2 * err_j + 2 * ulp, k
    assert not tmodel.training


def test_llava_train_full_moves_the_base():
    jmodel, variables, tmodel = _llava_pair(seed=1)
    samples = ttr.make_synthetic_vla_dataset(1, seed=2, num_candidates=2,
                                             image_size=28)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tt = LlavaLoRATrainer(tmodel, Tok(), learning_rate=1e-3, max_len=96,
                          train_full=True, device="cpu")
    out = tt.fine_tune(samples, epochs=1, batch_size=2)
    assert np.isfinite(out["final_loss"])
    after = tmodel.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    for k in ("vision_tower.layers.0.fc1.weight", "embed_tokens.weight",
              "layers.1.gate_proj.base.weight", "lm_head.weight",
              "layers.0.self_attn.q_proj.lora_a"):
        assert k in moved, k


def test_llava_max_len_within_the_image_tokens_raises_as_jax_does():
    jmodel, variables, tmodel = _llava_pair()
    samples = ttr.make_synthetic_vla_dataset(1, seed=0, num_candidates=2,
                                             image_size=28)
    n = TINY["image_size"] // TINY["patch_size"]
    for max_len in (n * n, n * n - 1):
        with pytest.raises(Exception):
            JTrainer(jmodel, variables, Tok(), max_len=max_len).fine_tune(
                samples, batch_size=2)
        tt = LlavaLoRATrainer(tmodel, Tok(), max_len=max_len, device="cpu")
        with pytest.raises(ValueError, match="num_patches"):
            tt.fine_tune(samples, batch_size=2)
    tt = LlavaLoRATrainer(tmodel, Tok(), max_len=40, device="cpu")
    ids, lm, _ = tt._example(samples[0], 0, 0.25)
    jids, jlm_, _ = JTrainer(jmodel, variables, Tok(), max_len=40) \
        ._example(samples[0], 0, 0.25)
    assert len(ids) == 40 and np.array_equal(ids, jids) \
        and np.array_equal(lm, jlm_)
    with pytest.raises(ValueError, match="lora_rank"):
        LlavaLoRATrainer(tl.LlavaTorch(tl.LlavaTorchConfig(
            **{**TINY, "lora_rank": 0}), device="cpu"), Tok(), device="cpu")


def test_llava_adapter_files_cross_between_the_packages(tmp_path):
    """An adapter ``.npz`` and its config written by the port load in the
    JAX trainer and give its logits, and the JAX trainer's load in the
    port's; then ``evaluate`` runs through ``LlavaTorchScorer``."""
    jmodel, variables, tmodel = _llava_pair(seed=3)
    tt = LlavaLoRATrainer(tmodel, Tok(), device="cpu")
    ids, px = np.random.default_rng(4).integers(1, 99, (2, 12)), \
        np.random.default_rng(5).standard_normal((2, 28, 28, 3))
    ids[:, 1:5] = 100
    px = px.astype(np.float32)
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            if tlora.is_lora_key(name):
                p.add_(0.01)               # the port's adapter moves...
    path = str(tmp_path / "port.npz")
    tt.save_adapter(path)
    cfg_j = json.load(open(path + ".adapter_config.json"))
    assert cfg_j == {"r": 4, "lora_alpha": 8.0, "lora_dropout": 0.0,
                     "base_model": "llava-jax",
                     "target_modules": ttr.TARGET_MODULES}
    jt = JTrainer(jmodel, variables, Tok())
    jt.load_adapter(path)                  # ...onto JAX's base
    with torch.no_grad():
        base = convert.flax_to_torch_llava(variables)
        tmodel.load_state_dict(tlora.merge_lora_params(
            base, tlora.extract_lora_params(tmodel.state_dict())))
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(px))[0]
    want = jmodel.apply(jt.variables, jnp.asarray(ids),
                        pixel_values=jnp.asarray(px))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=3e-5)
    jpath = str(tmp_path / "jax.npz")
    jt.save_adapter(jpath)
    tmodel.load_state_dict(base)
    tt.load_adapter(jpath)
    with torch.no_grad():
        again = tmodel(torch.from_numpy(ids), torch.from_numpy(px))[0]
    assert torch.equal(again, got)
    samples = ttr.make_synthetic_vla_dataset(1, seed=1, num_candidates=2,
                                             image_size=28)
    metrics = tt.evaluate(samples)
    assert set(metrics) == {"top1_accuracy", "spearman"}


# ---- the TinyVLA trainer -------------------------------------------------------------

SMALL = jlm.VLAModelConfig(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                           mlp_hidden=64, vision_tokens=2, vision_patch=16,
                           lora_rank=4, lora_alpha=8.0, lora_dropout=0.0)


def _tiny_trainers(cfg=SMALL, lr=3e-3):
    jt = jtr.VLATrainer(cfg=cfg, learning_rate=lr, seed=0)
    tcfg = ttr.VLAModelConfig(**dataclasses.asdict(cfg))
    tt = ttr.VLATrainer(cfg=tcfg, learning_rate=lr, seed=0, device="cpu")
    tt.model.load_state_dict(convert.flax_to_torch_tiny_vla(jt.variables))
    return jt, tt


def test_vla_trainer_loss_history_matches_jax_without_dropout():
    """``fine_tune`` for two epochs at ``lora_dropout=0``: the same
    batches in the same order (numpy shuffle, remainder dropped), the
    same AdamW, so the same loss history to 1e-4 relative; the frozen
    base unchanged. Then ``pretrain`` of a rank-0 trainer, its base
    grafted into a LoRA trainer, and ``fine_tune`` there, run."""
    jt, tt = _tiny_trainers()
    samples = jtr.make_synthetic_vla_dataset(2, seed=0, num_candidates=5,
                                             image_size=16)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    want = jt.fine_tune(samples, epochs=2, batch_size=4)
    got = tt.fine_tune(samples, epochs=2, batch_size=4)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-4)
    after = tt.model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v) != tlora.is_lora_key(k), k
    base = ttr.VLATrainer(cfg=dataclasses.replace(tt.cfg, lora_rank=0),
                          seed=1, device="cpu")
    pre = base.pretrain(samples, epochs=2, batch_size=4)
    assert len(pre["loss_history"]) == 2
    lora = ttr.VLATrainer(cfg=tt.cfg, seed=2, device="cpu")
    lora.model.load_state_dict(tlora.graft_base_params(
        lora.model.state_dict(), base.model.state_dict()))
    assert torch.equal(lora.model.layers[0].attn.q_proj.base.weight,
                       base.model.layers[0].attn.q_proj.base.weight)
    fit = lora.fine_tune(samples, epochs=1, batch_size=4)
    assert np.isfinite(fit["final_loss"])


def test_vla_trainer_applies_dropout_from_its_generator():
    """With ``lora_dropout > 0`` the TinyVLA trainer's adapters drop
    (the JAX ``VLATrainer`` passes ``train=True``): two trainers of the
    same seed give the same history, and it differs from the one at
    ``lora_dropout=0``."""
    cfg = ttr.VLAModelConfig(**{**dataclasses.asdict(SMALL),
                                "lora_dropout": 0.5})
    samples = ttr.make_synthetic_vla_dataset(2, seed=1, num_candidates=4,
                                             image_size=16)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, lora_dropout=0.0), cfg):
        t = ttr.VLATrainer(cfg=c, learning_rate=1e-2, seed=3, device="cpu")
        runs.append(t.fine_tune(samples, epochs=1, batch_size=4)
                    ["loss_history"])
    assert runs[0] == runs[2] and runs[0] != runs[1]


def test_vla_adapter_files_cross_between_the_packages(tmp_path):
    jt, tt = _tiny_trainers()
    with torch.no_grad():
        for name, p in tt.model.named_parameters():
            if tlora.is_lora_key(name):
                p.add_(0.05)
    path = str(tmp_path / "a.npz")
    tt.save_adapter(path)
    assert json.load(open(path + ".adapter_config.json")) == {
        "r": 4, "lora_alpha": 8.0, "lora_dropout": 0.0,
        "target_modules": ttr.TARGET_MODULES}
    jt.load_adapter(path)
    want = convert.flax_to_torch_tiny_vla(jt.variables)
    got = tt.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in got)
    jt2, tt2 = _tiny_trainers()
    jt.save_adapter(str(tmp_path / "j.npz"))
    tt2.load_adapter(str(tmp_path / "j.npz"))
    got2 = tt2.model.state_dict()
    assert all(torch.equal(got2[k], want[k]) for k in got2)


def test_shipped_sweep_adapter_evaluates_as_in_jax():
    """``artifacts/vla/pretrained_base.npz`` plus ``baseline_5e5``'s
    adapter, loaded by each package's ``VLATrainer``, give the same
    ``evaluate()`` on four scenes."""
    exp = texp.PRODUCTION_EXPERIMENTS[0]
    assert exp.name == "baseline_5e5"
    kw = dict(lora_rank=exp.lora_rank, lora_alpha=exp.lora_alpha,
              lora_dropout=exp.lora_dropout)
    jt = jtr.VLATrainer(cfg=jlm.VLAModelConfig(**kw), seed=0)
    tt = ttr.VLATrainer(cfg=ttr.VLAModelConfig(**kw), seed=0, device="cpu")
    for t in (jt, tt):
        t.load_pretrained_base(os.path.join(ARTIFACTS, "pretrained_base.npz"))
        t.load_adapter(os.path.join(ARTIFACTS, exp.name, "adapter.npz"))
    want = convert.flax_to_torch_tiny_vla(jt.variables)
    got = tt.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in got)
    scenes = ttr.make_synthetic_vla_dataset(4, seed=9, num_candidates=3)
    assert tt.evaluate(scenes) == jt.evaluate(scenes)


def test_sweep_writes_the_jax_sweeps_files_and_keys(tmp_path):
    """``run_vla_sweep`` at a tiny size writes the files of the shipped
    JAX sweep (``artifacts/vla``) with the same keys: the pretrained
    base's npz keys are JAX's for the same config, the adapters' and the
    history's keys those of the shipped files."""
    tiny = ttr.VLAModelConfig(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                              mlp_hidden=64, vision_tokens=2,
                              vision_patch=16)
    exps = [dataclasses.replace(e, epochs=1)
            for e in texp.PRODUCTION_EXPERIMENTS[:2]]
    results = texp.run_vla_sweep(str(tmp_path), experiments=exps,
                                 num_train=2, num_eval=1, model_cfg=tiny,
                                 pretrain_epochs=1, device="cpu")
    assert [r["experiment"] for r in results] == [e.name for e in exps]
    shipped = json.load(open(os.path.join(ARTIFACTS, "baseline_5e5",
                                          "training_history.json")))
    for e in exps:
        d = tmp_path / e.name
        hist = json.load(open(d / "training_history.json"))
        assert sorted(hist) == sorted(shipped)
        assert hist["pretrain_epochs"] == 1 and len(hist["loss_history"]) \
            == 1
        assert sorted(json.load(open(d / "adapter.npz.adapter_config.json"))) \
            == sorted(json.load(open(os.path.join(
                ARTIFACTS, e.name, "adapter.npz.adapter_config.json"))))
        with np.load(d / "adapter.npz") as a, np.load(os.path.join(
                ARTIFACTS, e.name, "adapter.npz")) as b:
            assert {k.split("/", 1)[1] for k in a.files} <= \
                {k.split("/", 1)[1] for k in b.files}
    summary = json.load(open(tmp_path / "sweep_summary.json"))
    assert sorted(r["experiment"] for r in summary) == \
        sorted(e.name for e in exps)
    jvars = _jax_init_vla(0, jlm.VLAModelConfig(**dataclasses.asdict(tiny)))
    with np.load(tmp_path / "pretrained_base.npz") as base:
        assert sorted(base.files) == sorted(
            "/".join(k) for k in tu.flatten_dict(jvars["params"]))
        fresh = jtr.VLATrainer(cfg=jlm.VLAModelConfig(
            **{**dataclasses.asdict(tiny), "lora_rank": 8}), seed=0)
    fresh.load_pretrained_base(str(tmp_path / "pretrained_base.npz"))
    fresh.load_adapter(str(tmp_path / exps[0].name / "adapter.npz"))


def test_vla_package_exports_the_trainer():
    import leafgrasp_tpu_torch.vla as tvla
    assert tvla.VLATrainer is ttr.VLATrainer
    assert tvla.make_synthetic_vla_dataset is ttr.make_synthetic_vla_dataset
    assert tvla.spearman_correlation is ttr.spearman_correlation
    assert types.ModuleType  # the module's names stay importable
