"""The port's GPipe pipeline over the LLaVA decoder
(leafgrasp_tpu_torch/parallel/pipeline.py) against the JAX package's
plain ``LlavaJax``, the counterparts of tests/test_parallel.py's pipeline
cases.

The JAX side runs in this process, unsharded, on the Flax weights that
``flax_to_torch_llava`` hands the port. The port's side runs on four
spawned gloo CPU ranks (tests/_torch_dist.py), one spawn for the whole
file (a module fixture): the stages over the data axis of a (4, 1)
mesh, over the model axis of a (1, 4) mesh, and two stages times two-way
tensor parallelism on a (2, 2) mesh (JAX's test: eight stages, four on
the model axis, and four stages times two on eight devices). Rank
functions are module-level and this module imports no JAX at the top.

Tolerances are the JAX tests': logits 1e-4 relative / 1e-5 absolute,
gradients 2e-3 relative / 1e-5 absolute, each checked on every rank
(the stage gradients on the rank that holds the stage).
"""

import numpy as np
import pytest
import torch

from tests._torch_dist import spawn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vis_hidden=16, vis_intermediate=32, vis_layers=1, vis_heads=2,
            image_size=28, patch_size=14, vocab_size=64, hidden=16,
            intermediate=32, layers=8, heads=2, kv_heads=1,
            image_token_index=60)
PPTP = dict(TINY, heads=4, kv_heads=2)
IDS = np.tile(np.array([[1, 60, 60, 60, 60, 2, 7, 9]], np.int32), (4, 1))
PX = np.linspace(-1, 1, 4 * 28 * 28 * 3, dtype=np.float32).reshape(
    4, 28, 28, 3)
TGT = np.arange(4 * 8, dtype=np.int64).reshape(4, 8) % 64
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
WORLD = 4
# models that tp_axis refuses, and the words of the refusal
REJECTED = {"heads": dict(TINY), "quantized": dict(PPTP, quantized=True),
            "lora": dict(PPTP, lora_rank=2)}
REJECTIONS = {"heads": "TP size", "quantized": "plain Dense layers only",
              "lora": "plain Dense layers only"}


# ------------------------------------------------------------ rank bodies --

def _model(fields, state, **kw):
    import dataclasses
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig)
    cfg = dataclasses.replace(LlavaTorchConfig(**fields), **kw)
    return cfg, LlavaTorch.from_state(cfg, state)


def _nll(logits, tgt):
    """JAX's test loss: -mean over positions of the target's
    log-probability."""
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()


def _pp_logits(mesh, fields, state, n_micro, axis="data", tp_axis=None,
               image_features=None, last_only=False, **kw):
    from leafgrasp_tpu_torch.parallel import (make_pp_llava_forward,
                                              shard_stage_params,
                                              split_decoder_stages)
    from leafgrasp_tpu_torch.parallel.mesh import mesh_shape
    cfg, model = _model(fields, state, **kw)
    stages, rest = split_decoder_stages(model.state_dict(), cfg,
                                        mesh_shape(mesh)[axis])
    local = shard_stage_params(mesh, stages, axis=axis, tp_axis=tp_axis)
    fn = make_pp_llava_forward(mesh, model, n_microbatches=n_micro,
                               axis=axis, tp_axis=tp_axis,
                               logits_last_only=last_only)
    ids = torch.from_numpy(IDS).long()
    with torch.no_grad():
        if image_features is not None:
            out = fn(rest, local, ids, image_features=image_features)
        else:
            out = fn(rest, local, ids, torch.from_numpy(PX))
    return out.numpy(), local


def _pp_grads(mesh, fields, state, remat):
    """(loss, {state key: gradient}) of this rank: the replicated rest's
    and its own stage's, the stage's under their whole model's keys."""
    from leafgrasp_tpu_torch.parallel import (make_pp_llava_forward,
                                              shard_stage_params,
                                              split_decoder_stages)
    from leafgrasp_tpu_torch.parallel.collectives import Axis
    cfg, model = _model(fields, state)
    pp = Axis(mesh, "data")
    stages, rest = split_decoder_stages(model.state_dict(), cfg, pp.size)
    local = shard_stage_params(mesh, stages)
    fn = make_pp_llava_forward(mesh, model, n_microbatches=4, remat=remat)
    loss = _nll(fn(rest, local, torch.from_numpy(IDS).long(),
                   torch.from_numpy(PX)), torch.from_numpy(TGT))
    loss.backward()
    per = cfg.layers // pp.size
    grads = {}
    for name, p in rest.named_parameters():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
    for name, p in local.named_parameters():
        j, rest_key = name.split(".", 1)
        grads[f"layers.{pp.index * per + int(j)}.{rest_key}"] = p.grad
    return float(loss), {k: g.detach().clone() for k, g in grads.items()}


def _pipeline_ranks(rank, world, states):
    """Every case of the file on one spawn of ``world`` ranks."""
    from leafgrasp_tpu_torch.parallel import (make_mesh,
                                              make_pp_llava_forward)
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig)

    out = {}
    data = make_mesh(world, model_axis=1, device="cpu")
    model_mesh = make_mesh(world, model_axis=world, device="cpu")
    pptp = make_mesh(world, model_axis=2, device="cpu")
    out["m4"] = _pp_logits(data, TINY, states["plain"], 4)[0]
    out["m2_window3"] = _pp_logits(data, TINY, states["window3"], 2,
                                   sliding_window=3)[0]
    out["model_axis_last"] = _pp_logits(model_mesh, TINY, states["plain"],
                                        4, axis="model", last_only=True)[0]
    out["quant"] = _pp_logits(data, TINY, states["quant"], 4,
                              quantized=True, quant_group=8)[0]
    out["image_features"] = _pp_logits(
        data, TINY, states["plain"], 4,
        image_features=torch.from_numpy(states["feats"]))[0]
    for remat in (False, True):
        out[f"grads_remat{remat}"] = _pp_grads(data, TINY, states["plain"],
                                               remat)
    logits, local = _pp_logits(pptp, PPTP, states["pptp"], 4,
                               tp_axis="model")
    out["pptp"] = logits
    out["pptp_shapes"] = [
        (tuple(layer.self_attn.q_proj.weight.shape),
         tuple(layer.self_attn.o_proj.weight.shape)) for layer in local]
    out["tp_reject"] = {}
    for case, fields in REJECTED.items():
        try:
            make_pp_llava_forward(
                pptp, LlavaTorch(LlavaTorchConfig(**fields), device="meta"),
                n_microbatches=4, tp_axis="model")
            out["tp_reject"][case] = None
        except ValueError as exc:
            out["tp_reject"][case] = str(exc)
    return out


# --------------------------------------------------------------- fixtures --

def _jax_model(fields, sliding_window=None):
    """JAX's ``_tiny_llava``: a LlavaJax initialised on the test input."""
    import jax
    import jax.numpy as jnp
    from leafgrasp_tpu.vla.llava_jax import LlavaJax, LlavaJaxConfig
    model = LlavaJax(LlavaJaxConfig(**fields,
                                    sliding_window=sliding_window))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(IDS),
                           pixel_values=jnp.asarray(PX))
    return model, jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def jax_side():
    """The plain JAX forwards and gradients, and the states handed to
    the ranks."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import flax.traverse_util as tu
    from leafgrasp_tpu.vla.llava_jax import LlavaJax
    from leafgrasp_tpu.vla.quant import quantize_llava_variables
    from leafgrasp_tpu_torch.vla.convert import flax_to_torch_llava

    def logits(model, variables, **kw):
        return np.asarray(model.apply(variables, jnp.asarray(IDS), **kw)[0])

    model, variables = _jax_model(TINY)
    wmodel, wvars = _jax_model(TINY, sliding_window=3)
    qmodel = LlavaJax(dataclasses.replace(model.cfg, quantized=True,
                                          quant_group=8))
    qvars = quantize_llava_variables(variables)
    tmodel, tvars = _jax_model(PPTP)
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                         (16, TINY["hidden"]),
                                         jnp.float32))

    def loss(params):
        lg, _ = model.apply({"params": params}, jnp.asarray(IDS),
                            pixel_values=jnp.asarray(PX))
        lp = jax.nn.log_softmax(lg, axis=-1)
        oh = jax.nn.one_hot(jnp.asarray(TGT), lp.shape[-1])
        return -jnp.mean(jnp.sum(lp * oh, axis=-1))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = {
        "m4": logits(model, variables, pixel_values=PX),
        "m2_window3": logits(wmodel, wvars, pixel_values=PX),
        "quant": logits(qmodel, qvars, pixel_values=PX),
        "image_features": logits(model, variables, image_features=feats),
        "pptp": logits(tmodel, tvars, pixel_values=PX),
        "loss": float(jax.jit(loss)(variables["params"])),
        "grads": {"/".join(k): np.asarray(v) for k, v in
                  tu.flatten_dict(jax.device_get(grads)).items()},
    }
    want["model_axis_last"] = want["m4"][:, -1:]
    states = {"plain": flax_to_torch_llava(variables),
              "window3": flax_to_torch_llava(wvars),
              "quant": flax_to_torch_llava(jax.device_get(qvars)),
              "pptp": flax_to_torch_llava(tvars), "feats": feats}
    return want, states


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    return spawn(_pipeline_ranks, WORLD, tmp_path_factory.mktemp("pipe"),
                 jax_side[1])


# ------------------------------------------------------------------ tests --

@pytest.mark.parametrize("case", ["m4", "m2_window3"])
def test_pp_llava_forward_matches_plain(ranks, jax_side, case):
    """GPipe forward over four stages (M 4, no window; M 2, window 3) ==
    the plain LlavaJax forward, on every rank."""
    for out in ranks:
        np.testing.assert_allclose(out[case], jax_side[0][case], rtol=RTOL,
                                   atol=ATOL)


def test_pp_llava_on_model_axis_and_last_only(ranks, jax_side):
    """The pipeline over the model axis of a (1, 4) mesh, last-position
    logits."""
    for out in ranks:
        assert out["model_axis_last"].shape == (4, 1, 64)
        np.testing.assert_allclose(out["model_axis_last"],
                                   jax_side[0]["model_axis_last"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_pp_llava_grad_matches_plain(ranks, jax_side, remat):
    """Autograd through the pipeline == the plain model's gradients, for
    the staged layers (on the rank that holds each stage) and the
    replicated rest (embedding, vision tower, norm, lm_head) on every
    rank."""
    from leafgrasp_tpu_torch.vla.convert import torch_to_flax_llava
    want = jax_side[0]["grads"]
    seen = set()
    for out in ranks:
        loss, grads = out[f"grads_remat{remat}"]
        np.testing.assert_allclose(loss, jax_side[0]["loss"], rtol=RTOL)
        got = torch_to_flax_llava(grads)
        for key, g in got.items():
            np.testing.assert_allclose(g, want[key], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=key)
        seen |= set(got)
    assert seen == set(want)


def test_pp_llava_forward_quantized(ranks, jax_side):
    """PP forward over an int8-quantized model == the plain quantized
    forward (the QuantDense lm_head in the replicated head)."""
    for out in ranks:
        np.testing.assert_allclose(out["quant"], jax_side[0]["quant"],
                                   rtol=RTOL, atol=ATOL)


def test_pp_llava_forward_image_features(ranks, jax_side):
    """Packed image_features (4 rows x 4 image tokens) through the
    pipeline == the plain model."""
    for out in ranks:
        np.testing.assert_allclose(out["image_features"],
                                   jax_side[0]["image_features"],
                                   rtol=RTOL, atol=ATOL)


def test_pp_tp_llava_forward_matches_plain(ranks, jax_side):
    """Two stages over data times two-way TP over model: each rank holds
    its four layers' head slices (q_proj (out / 2, in), o_proj (out,
    in / 2)); the forward matches the plain model."""
    for out in ranks:
        assert out["pptp_shapes"] == [((8, 16), (16, 8))] * 4
        np.testing.assert_allclose(out["pptp"], jax_side[0]["pptp"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_pp_tp_rejects_indivisible_heads(ranks, case):
    """kv_heads 1 over two-way TP; a quantized or LoRA model under
    tp_axis."""
    for out in ranks:
        assert REJECTIONS[case] in out["tp_reject"][case]


def test_pp_split_rejects_indivisible():
    from leafgrasp_tpu_torch.parallel import split_decoder_stages
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    with pytest.raises(ValueError, match="not divisible"):
        split_decoder_stages({}, LlavaTorchConfig(**dict(TINY, layers=6)), 4)



def test_random_llava_state_draws_what_init_random_draws():
    """A pipeline rank draws its stage and the rest only, and gets the
    tensors ``init_random_`` gives the whole model from the same seed."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_,
                                                     random_llava_state)
    cfg = LlavaTorchConfig(**TINY, image_grid_pinpoints=((28, 56),))
    full = init_random_(LlavaTorch(cfg, device="cpu"),
                        torch.Generator().manual_seed(0)).state_dict()

    def keep(key):
        return key.startswith("layers.5.") or not key.startswith("layers.")
    part = random_llava_state(cfg, torch.Generator().manual_seed(0), keep,
                              device="cpu")
    assert set(part) == {k for k in full if keep(k)}
    for key, value in part.items():
        assert torch.equal(value, full[key]), key


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_llava_flax_names_round_trip(lora_rank):
    """``torch_to_flax_llava`` (through ``llava_flax_name``, which the
    tensor-parallel rule reads) gives back the Flax variables that
    ``flax_to_torch_llava`` took, names and orientation."""
    import flax.traverse_util as tu
    from leafgrasp_tpu_torch.vla.convert import (flax_to_torch_llava,
                                                 torch_to_flax_llava)
    _, variables = _jax_model(dict(TINY, lora_rank=lora_rank))
    want = {"/".join(k): v for k, v in
            tu.flatten_dict(variables["params"]).items()}
    got = torch_to_flax_llava(flax_to_torch_llava(variables))
    assert set(got) == set(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
