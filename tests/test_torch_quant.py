"""The port's weight-only int8 / int4 quantization (``vla/quant.py``) and
the quantized LlavaTorch against the JAX package's, on the CPU at tiny
widths, on the same seeded weights (Flax init, crossed through
``vla/convert.py``).

Bit-equal: codes and scales (the port's quantizer against the JAX host
quantizer, and against JAX's quantized tree carried across: int8, int4
native and int4 packed), greedy tokens and parsed scores. Logits and
layer outputs in f32: 1e-5 relative and absolute (2e-5 for int4), as the
JAX tests hold their two formulations (another order of f32 sums). bf16:
one bf16 rounding of the f32 result (2^-8 of the value).
"""

import numpy as np
import pytest
import torch

import flax.traverse_util as tu
import jax
import jax.numpy as jnp

from leafgrasp_tpu.vla import llava_jax as jl
from leafgrasp_tpu.vla import llava_runtime as jr
from leafgrasp_tpu.vla import quant as jq
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import llava_runtime as tr
from leafgrasp_tpu_torch.vla import llava_torch as tl
from leafgrasp_tpu_torch.vla import quant as tq
from leafgrasp_tpu_torch.vla.lora import lora_mask

TINY = dict(vis_hidden=32, vis_intermediate=64, vis_layers=2, vis_heads=2,
            image_size=28, patch_size=14, vocab_size=128, hidden=32,
            intermediate=64, layers=2, heads=4, kv_heads=2,
            image_token_index=100)
IDS = np.array([[1, 5, 100, 100, 100, 100, 7, 9]], np.int32)
TOL = 1e-5


def _init(seed=0, **kw):
    """JAX model and Flax variables (init at ``seed``) and the port's
    float state_dict of the same weights."""
    cfg = jl.LlavaJaxConfig(**TINY, **kw)
    model = jl.LlavaJax(cfg)
    px = np.random.default_rng(seed).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(IDS),
                           pixel_values=jnp.asarray(px))
    return model, variables, px


def _port(variables, **kw):
    """The port's model from JAX variables (float or quantized)."""
    cfg = tl.LlavaTorchConfig(**TINY, **kw)
    return tl.LlavaTorch.from_state(cfg, convert.flax_to_torch_llava(
        variables))


def _port_quantized(variables, bits=8, group=128, **kw):
    """The port's own quantizer on the port's float state."""
    state = tq.quantize_llava_variables(
        convert.flax_to_torch_llava(variables), bits=bits, group=group)
    cfg = tl.LlavaTorchConfig(**TINY, quantized=True, quant_bits=bits,
                              quant_group=group, **kw)
    return tl.LlavaTorch.from_state(cfg, state), state


def _logits(model, px):
    with torch.no_grad():
        out, _ = model(torch.from_numpy(IDS).long(),
                       pixel_values=torch.from_numpy(px))
    return out.float().numpy()


def _jlogits(cfg_kw, variables, px):
    out, _ = jl.LlavaJax(jl.LlavaJaxConfig(**TINY, **cfg_kw)).apply(
        variables, IDS, pixel_values=px)
    return np.asarray(out, np.float32)


def _lm_weights(state):
    return [k for k in state if tq.is_quantized_weight(k)]


# ---- the quantizer ------------------------------------------------------------------

def test_quantize_error_bound_and_passthrough():
    """Per-column dequant error <= scale / 2; every LM projection and
    lm_head replaced (vision projections not); other leaves unchanged."""
    _, variables, _ = _init()
    state = convert.flax_to_torch_llava(variables)
    keys = _lm_weights(state)
    assert len(keys) == 2 * 7 + 1       # 7 projections x 2 layers + head
    assert not any("vision_tower" in k for k in keys)
    qstate = tq.quantize_llava_variables(state)
    for k in keys:
        w = state[k].T.float()
        q, s = qstate[k[:-6] + "kernel_q"], qstate[k[:-6] + "kernel_scale"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert q.shape == w.shape and s.shape == (w.shape[1],)
        assert ((q.float() * s - w).abs() <= s / 2 + 1e-7).all()
        assert k not in qstate
    for k, v in state.items():
        if k not in keys:
            assert qstate[k] is v


@pytest.mark.parametrize("bits,packed", [(8, False), (4, False), (4, True)])
def test_carried_jax_quantization_equals_the_ports(bits, packed):
    """JAX's quantize_llava_variables, then flax_to_torch_llava, gives
    the bits of the port's quantizer on the converted float weights (int4
    native packed into nibbles by the converter)."""
    _, variables, _ = _init(seed=11)
    carried = convert.flax_to_torch_llava(
        jq.quantize_llava_variables(variables, bits=bits, group=16,
                                    packed=packed))
    mine = tq.quantize_llava_variables(
        convert.flax_to_torch_llava(variables), bits=bits, group=16)
    assert set(carried) == set(mine)
    for k in mine:
        assert mine[k].dtype == carried[k].dtype, k
        assert torch.equal(mine[k], carried[k]), k


def test_int4_error_bound_group_layout():
    """int4: (in / 2, out) packed codes with |q| <= 7, (G, out) scales,
    per-group dequant error <= scale / 2; a group that does not divide
    the input falls back to one scale row."""
    _, variables, _ = _init(seed=11)
    state = convert.flax_to_torch_llava(variables)
    qstate = tq.quantize_llava_variables(state, bits=4, group=16)
    for k in _lm_weights(state):
        w = state[k].T.float()
        n_in, n_out = w.shape
        q, s = qstate[k[:-6] + "kernel_q"], qstate[k[:-6] + "kernel_scale"]
        assert q.shape == (n_in // 2, n_out) and q.dtype == torch.int8
        assert s.shape == (n_in // 16, n_out)
        lo, hi = tq._unpack_nibbles(q)
        codes = torch.stack([lo, hi], dim=1).reshape(n_in, n_out)
        assert codes.abs().max() <= 7
        err = (codes.reshape(-1, 16, n_out).float() * s[:, None, :]
               - w.reshape(-1, 16, n_out)).abs()
        assert (err <= s[:, None, :] / 2 + 1e-7).all()
    q, s = tq.quantize_kernel(torch.randn(24, 5), bits=4, group=16)
    assert q.shape == (12, 5) and s.shape == (1, 5)
    with pytest.raises(ValueError, match="even group"):
        tq.quantize_kernel(torch.randn(24, 5), bits=4, group=3)


def test_pack_unpack_nibbles_round_trip_and_match_jax():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(4).reshape(16, 4)
    p = tq.pack_nibbles(codes)
    lo, hi = tq._unpack_nibbles(p)
    assert torch.equal(torch.stack([lo, hi], dim=1).reshape(16, 4), codes)
    jlo, jhi = jq._unpack_nibbles(jnp.asarray(p.numpy()))
    assert np.array_equal(np.asarray(jlo), lo.numpy())
    assert np.array_equal(np.asarray(jhi), hi.numpy())


def test_device_quantize_matches_host_and_consumes_box():
    """quantize_llava_state_device: the host quantizer's codes and scales
    exactly (true division on every device; JAX's device variant is only
    held within one code), the JAX host path's too, a zero column
    guarded, and the input box emptied."""
    _, variables, _ = _init(seed=11)
    flat = tu.flatten_dict(variables)
    k0 = ("params", "layer_0", "self_attn", "q_proj", "kernel")
    w = np.asarray(flat[k0]).copy()
    w[:, 0] = 0.0
    flat[k0] = jnp.asarray(w)
    variables = tu.unflatten_dict(flat)
    state = convert.flax_to_torch_llava(variables)
    host = tq.quantize_llava_variables(state, bits=8)
    jhost = convert.flax_to_torch_llava(
        jq.quantize_llava_variables(variables, bits=8))
    box = [dict(state)]
    dev = tq.quantize_llava_state_device(box, bits=8)
    assert box == []
    assert set(dev) == set(host) == set(jhost)
    for k in host:
        assert torch.equal(dev[k], host[k]), k
        d = (dev[k].to(torch.int32) - jhost[k].to(torch.int32)).abs() \
            if dev[k].dtype == torch.int8 else None
        assert d is None or d.max() <= 1, k
        assert torch.equal(dev[k], jhost[k]), k
    assert dev["layers.0.self_attn.q_proj.kernel_scale"][0] == 1.0
    with pytest.raises(ValueError):
        tq.quantize_llava_state_device([dev], bits=4)
    with pytest.raises(ValueError):
        tq.quantize_llava_state_device(dev)      # not boxed


# ---- the quantized model ------------------------------------------------------------

def _representable(variables, qmax, group=None):
    """Snap every LM kernel to codes x a power-of-two scale, each column's
    (or group's) largest code pinned to qmax, so quantization is exact."""
    flat = dict(tu.flatten_dict(variables))
    s0 = np.float32(2.0 ** -5)
    for k in list(flat):
        if k[-1] == "kernel" and set(k) & set(tq.LM_PROJ_NAMES) \
                and "vision_tower" not in k:
            w = np.asarray(flat[k], np.float32)
            q0 = np.clip(np.rint(w / s0), -qmax, qmax)
            g = w.shape[0] // group if group else 1
            q0 = q0.reshape(g, -1, w.shape[1])
            q0[:, 0, :] = qmax
            flat[k] = jnp.asarray(q0.reshape(w.shape) * s0)
    return tu.unflatten_dict(flat)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_logits_exact_on_representable_weights(bits):
    """Kernels snapped to int x power-of-two scale survive quantization
    exactly: the quantized model's logits equal the float model's, and
    JAX's quantized model's."""
    kw = dict(quant_bits=bits, quant_group=16)
    _, variables, px = _init(seed=0 if bits == 8 else 13)
    variables = _representable(variables, 127 if bits == 8 else 7,
                               group=16 if bits == 4 else None)
    tol = TOL if bits == 8 else 2e-5
    ref = _logits(_port(variables), px)
    qmodel, _ = _port_quantized(variables, bits=bits, group=16)
    got = _logits(qmodel, px)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    want = _jlogits(dict(quantized=True, **kw),
                    jq.quantize_llava_variables(variables, bits=bits,
                                                group=16), px)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_generate_and_scorer_match_jax(bits):
    """The quantized model drives greedy generate (scan and steps give
    the same tokens, JAX's tokens) and the scorer (JAX's scores)."""
    kw = dict(quantized=True, quant_bits=bits, quant_group=16)
    _, variables, _ = _init(seed=3 if bits == 8 else 17)
    qvars = jq.quantize_llava_variables(variables, bits=bits, group=16)
    jmodel = jl.LlavaJax(jl.LlavaJaxConfig(**TINY, **kw))
    qmodel, _ = _port_quantized(variables, bits=bits, group=16)
    ids = torch.from_numpy(IDS[:, :4]).long()
    toks = {m: tl.greedy_generate_llava(qmodel, ids, max_new_tokens=5,
                                        decode_mode=m).numpy()
            for m in ("scan", "steps")}
    want = np.asarray(jl.greedy_generate_llava(
        jmodel, qvars, IDS[:, :4], max_new_tokens=5, decode_mode="steps"))
    assert np.array_equal(toks["scan"], toks["steps"])
    assert np.array_equal(toks["steps"], want)

    class _Tok:
        def encode(self, text):
            return [1] + [b % 90 + 2 for b in text.encode()][:9]

        def decode(self, ids):
            return f"0.{abs(sum(int(i) for i in ids)) % 100:02d}"

    cands = [dict(x=i, y=i, geometric_score=0.5) for i in range(3)]
    img = np.random.default_rng(4).random((30, 30, 3)).astype(np.float32)
    got = tr.LlavaTorchScorer(qmodel, _Tok(), max_new_tokens=3) \
        .score(img, cands, "go")
    assert got == jr.LlavaJaxScorer(jmodel, qvars, _Tok(),
                                    max_new_tokens=3).score(img, cands, "go")
    assert len(got) == 3 and all(0.0 <= s <= 1.0 for s in got)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_layout_and_mask(bits):
    """quantized + lora_rank > 0: the base quantizes under ``base``,
    lora_a / lora_b stay float and lora_mask marks exactly them; the
    logits equal JAX's QLoRA model's on the same adapters."""
    kw = dict(lora_rank=2)
    _, variables, px = _init(seed=5 if bits == 8 else 19, **kw)
    # adapters that change the output (lora_b is zero at init)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 if "lora_b" in jax.tree_util.keystr(p) else v,
        variables)
    qvars = jq.quantize_llava_variables(variables, bits=bits, group=16)
    qmodel, state = _port_quantized(variables, bits=bits, group=16, **kw)
    assert "layers.0.self_attn.q_proj.base.kernel_q" in state
    assert "layers.0.self_attn.q_proj.lora_a" in state
    assert isinstance(qmodel.layers[0].self_attn.q_proj, tq.QuantLoRADense)
    trainable = {k for k, v in lora_mask(qmodel.state_dict()).items() if v}
    assert trainable and all(k.endswith(("lora_a", "lora_b"))
                             for k in trainable)
    got = _logits(qmodel, px)
    assert np.isfinite(got).all()
    want = _jlogits(dict(quantized=True, quant_bits=bits, quant_group=16,
                         **kw), qvars, px)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---- the layer ----------------------------------------------------------------------

def _jax_layer(features, q, s, x, dtype, threshold, bits=4, packed=True):
    lay = jq.QuantDense(features, dtype=dtype, bits=bits, group=16,
                        packed=packed, dequant_threshold=threshold)
    v = lay.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = tu.flatten_dict(v)
    flat[("params", "kernel_q")] = q
    flat[("params", "kernel_scale")] = jnp.asarray(s)
    return np.asarray(lay.apply(tu.unflatten_dict(flat), jnp.asarray(x)),
                      np.float32)


def _port_layer(in_f, features, q, s, threshold, dtype=torch.float32,
                bits=4):
    lay = tq.QuantDense(in_f, features, dtype=dtype, bits=bits, group=16,
                        dequant_threshold=threshold, device="cpu")
    with torch.no_grad():
        lay.kernel_q.copy_(q)
        lay.kernel_scale.copy_(s)
    return lay


@pytest.mark.parametrize("packed", [False, True])
def test_int4_formulations_agree_and_match_jax(packed):
    """QuantDense picks per-group f32 partials (at or below the
    threshold) or one dequantized product (above) by the token count; in
    f32 both compute x @ (Q * scale), and each equals JAX's layer in the
    same formulation (JAX's storage native or packed)."""
    rng = np.random.default_rng(29 if not packed else 37)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    codes = rng.integers(-7, 8, size=(32, 24)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, size=(2, 24)).astype(np.float32)
    p = tq.pack_nibbles(torch.from_numpy(codes))
    jqk = jnp.asarray(p.numpy()) if packed else \
        jnp.asarray(codes).astype(jnp.int4)
    out = {}
    for name, thr in (("partials", 10 ** 9), ("dequant", 0)):
        lay = _port_layer(32, 24, p, torch.from_numpy(s), thr)
        with torch.no_grad():
            out[name] = lay(torch.from_numpy(x)).numpy()
        want = _jax_layer(24, jqk, s, x, jnp.float32, thr, packed=packed)
        np.testing.assert_allclose(out[name], want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["partials"], out["dequant"], rtol=TOL,
                               atol=TOL)
    # the default threshold: 300 tokens dequantize, 256 take partials
    lay = _port_layer(32, 24, p, torch.from_numpy(s), 256)
    with torch.no_grad():
        np.testing.assert_array_equal(lay(torch.from_numpy(x)).numpy(),
                                      out["dequant"])
        np.testing.assert_array_equal(
            lay(torch.from_numpy(x[:256])).numpy(), out["partials"][:256])


@pytest.mark.parametrize("form", ["int8", "int4_partials",
                                  "int4_dequant"])
def test_one_rounding_share_tells_the_rounding_orders_apart(form):
    """bf16 compute against the f64 product (one_rounding_share, the
    card's check too): int8's (x @ Q) comes back in f32, is scaled in f32
    and rounded to bf16 once, and meets it, as JAX's int8 layer does; a
    bf16 product before the scale double-rounds (the JAX package saw that
    flip 100 of 100 greedy paths) and misses it. int4's per-group
    partials round once and meet it; its dequantized product rounds the
    weight first and misses it (held to a wider tolerance elsewhere)."""
    rng = np.random.default_rng(43)
    n_in, n_out, rows = 256, 96, 40
    w = torch.from_numpy(0.02 * rng.normal(size=(n_in, n_out))
                         .astype(np.float32))
    x = rng.normal(size=(rows, n_in)).astype(np.float32)
    bits = 8 if form == "int8" else 4
    q, s = tq.quantize_kernel(w, bits, 16)
    thr = 0 if form == "int4_dequant" else 256
    lay = _port_layer(n_in, n_out, q, s, thr, dtype=torch.bfloat16,
                      bits=bits)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = lay(torch.from_numpy(x))
        exact = tq.quant_dense_exact(lay, xb)
    share = tq.one_rounding_share(got, exact)
    if form == "int4_dequant":
        assert share > 1.0
        return
    assert share <= 1.0
    if form == "int8":
        # (XLA on the CPU has no bf16 product with an f32 result for
        # int4's grouped partials, so JAX's layer is held here for int8)
        want = _jax_layer(n_out, q.numpy(), s.numpy(), x, jnp.bfloat16,
                          thr, bits=8, packed=False)
        assert tq.one_rounding_share(torch.from_numpy(want), exact) <= 1.0
        twice = (torch.mm(xb, q.bfloat16()).float() * s).bfloat16()
        assert tq.one_rounding_share(twice, exact) > 1.0


def test_quant_layers_reject_what_they_lack():
    with pytest.raises(ValueError, match="bits"):
        tq.QuantDense(32, 8, bits=3)
    with pytest.raises(ValueError, match="even group"):
        tq.QuantDense(24, 8, bits=4, group=3)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_llava_variables({}, bits=2)
