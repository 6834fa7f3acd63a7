"""The port's tensor-parallel LLaVA and TinyVLA
(``parallel/sharding.py``'s ``tensor_parallel_``) against the JAX
package: the counterparts of ``__graft_entry__.dryrun_multichip``'s
paths 3 to 7 and 11, where the JAX package shards the variables with
``shard_variables`` and lets GSPMD run the model, and of the two
quantized placement tests of tests/test_quant.py.

The JAX side runs unsharded in this process on the Flax weights that
``flax_to_torch_llava`` hands the port; the port's side runs on four
spawned gloo CPU ranks, one spawn for the file: a (2, 2) mesh for the
models, a (1, 4) mesh for the placements (JAX's test: (2, 4) on eight
devices; the rule reads only the model axis' size).

Tolerances: logits and projected vision features 1e-4 relative / 1e-5
absolute (as tests/test_torch_llava.py: other orders of f32 sums),
greedy tokens equal. The TinyVLA step is held to the single-process
port step on the same seed, loss 1e-6 relative and every tensor 1e-6
absolute: the column slices sum their products in other orders.
"""

import numpy as np
import pytest
import torch

from tests._torch_dist import spawn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
# __graft_entry__.py:173-177 at a model axis of 2
LCFG = dict(vis_hidden=16, vis_intermediate=32, vis_layers=1, vis_heads=2,
            image_size=28, patch_size=14, vocab_size=64, hidden=16,
            intermediate=32, layers=1, heads=2, kv_heads=1,
            image_token_index=60)
PINPOINTS = ((28, 56), (56, 28), (56, 56))
IDS = np.array([[1, 60, 60, 60, 60, 2]], np.int32)
IDSB = np.array([[1, 60, 60, 60, 60, 2, 3], [0, 1, 60, 60, 60, 60, 5]],
                np.int32)
PADS = np.array([0, 1], np.int32)
PX = np.linspace(-1, 1, 2 * 28 * 28 * 3, dtype=np.float32).reshape(
    2, 28, 28, 3)
MODES = {"f32": {}, "int8": dict(quantized=True),
         "int4": dict(quantized=True, quant_bits=4, quant_group=8)}
VLA_CFG = dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=1, mlp_hidden=32,
               vision_tokens=2, vision_patch=16, lora_rank=2, max_seq=600)
RTOL, ATOL = 1e-4, 1e-5
STEP_RTOL, STEP_ATOL = 1e-6, 1e-6


# ------------------------------------------------------------ rank bodies --

def _tp_llava(mesh, state, **kw):
    from leafgrasp_tpu_torch.parallel import tensor_parallel_
    from leafgrasp_tpu_torch.vla.convert import llava_flax_name
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig)
    model = LlavaTorch.from_state(LlavaTorchConfig(**LCFG, **kw), state)
    return model, tensor_parallel_(model, mesh, llava_flax_name)


def _vla_step(mesh=None):
    """One epoch (two steps) of dryrun path 3's TinyVLA LoRA fine-tune,
    tensor-parallel over ``mesh`` or single-process; returns the losses
    and the final state."""
    from leafgrasp_tpu_torch.parallel import tensor_parallel_
    from leafgrasp_tpu_torch.vla.convert import torch_to_flax_tiny_vla
    from leafgrasp_tpu_torch.vla.lm import VLAModelConfig
    from leafgrasp_tpu_torch.vla.trainer import (VLATrainer,
                                                 make_synthetic_vla_dataset)
    trainer = VLATrainer(cfg=VLAModelConfig(**VLA_CFG), learning_rate=1e-3,
                         device="cpu")
    replaced = []
    if mesh is not None:
        state = trainer.model.state_dict()
        replaced = tensor_parallel_(
            trainer.model, mesh,
            lambda k: next(iter(torch_to_flax_tiny_vla({k: state[k]}))))
    fit = trainer.fine_tune(make_synthetic_vla_dataset(
        2, seed=0, num_candidates=2, image_size=16), epochs=1, batch_size=2)
    return (fit["loss_history"], replaced,
            {k: v.clone() for k, v in trainer.model.state_dict().items()})


def _tp_ranks(rank, world, states, tiles, hw):
    from leafgrasp_tpu_torch.parallel import (infer_param_shardings,
                                              make_mesh)
    from leafgrasp_tpu_torch.parallel.mesh import mesh_shape
    from leafgrasp_tpu_torch.vla.convert import llava_flax_name
    from leafgrasp_tpu_torch.vla.llava_next import pack_anyres_features
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    from torch.distributed.tensor import Shard

    out = {}
    mesh = make_mesh(world, model_axis=2, device="cpu")
    model, out["replaced"] = _tp_llava(mesh, states["f32"])
    with torch.no_grad():
        out["logits"] = model(torch.from_numpy(IDS).long(),
                              torch.from_numpy(PX[:1]))[0].numpy()
    for mode, kw in MODES.items():
        model, _ = _tp_llava(mesh, states[mode], **kw)
        out[f"tokens_{mode}"] = greedy_generate_llava(
            model, torch.from_numpy(IDSB).long(), torch.from_numpy(PX),
            max_new_tokens=3, pad_lens=torch.from_numpy(PADS)).numpy()
    model, _ = _tp_llava(mesh, states["anyres"],
                         image_grid_pinpoints=PINPOINTS)
    with torch.no_grad():
        feats = model.vision_project(torch.from_numpy(tiles)).numpy()
    packed = pack_anyres_features(feats, hw, PINPOINTS, model.cfg,
                                  model.image_newline.detach().numpy())
    ids = np.array([[1] + [60] * packed.shape[0] + [2, 3]])
    out["anyres_packed"] = packed
    out["anyres_tokens"] = greedy_generate_llava(
        model, torch.from_numpy(ids), image_features=torch.from_numpy(
            packed)[None], max_new_tokens=3).numpy()
    out["vla"] = _vla_step(mesh)
    out["model_index"] = mesh.get_local_rank("model")

    wide = make_mesh(world, model_axis=world, device="cpu")
    out["placements"] = {}
    for mode in ("int8", "int4"):
        specs = infer_param_shardings(states[mode], wide, llava_flax_name)
        out["placements"][mode] = {
            llava_flax_name(k): p[1].dim if isinstance(p[1], Shard) else None
            for k, p in specs.items()}
    out["wide_model"] = mesh_shape(wide)["model"]
    return out


# --------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def jax_side():
    """JAX's unsharded forward, generate in f32 / int8 / int4 and anyres
    generate on dryrun paths 4-7 and 11's model, the placements of
    tests/test_quant.py's mesh, and the states for the ranks."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from leafgrasp_tpu.parallel.sharding import infer_param_shardings
    from leafgrasp_tpu.vla.llava_jax import (LlavaJax, LlavaJaxConfig,
                                             _VisionProject,
                                             greedy_generate_llava)
    from leafgrasp_tpu.vla.llava_next import (pack_anyres_features,
                                              preprocess_anyres)
    from leafgrasp_tpu.vla.quant import quantize_llava_variables
    from leafgrasp_tpu_torch.vla.convert import flax_to_torch_llava

    cfg = LlavaJaxConfig(**LCFG)
    model = LlavaJax(cfg)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(IDS),
        pixel_values=jnp.asarray(PX[:1])))
    want = {"logits": np.asarray(model.apply(
        variables, jnp.asarray(IDS), pixel_values=jnp.asarray(PX[:1]))[0])}
    states = {}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    want["placements"] = {}
    for mode, kw in MODES.items():
        mcfg = dataclasses.replace(cfg, **kw)
        mvars = variables if mode == "f32" else jax.device_get(
            quantize_llava_variables(variables, bits=mcfg.quant_bits,
                                     group=mcfg.quant_group))
        want[f"tokens_{mode}"] = np.asarray(greedy_generate_llava(
            LlavaJax(mcfg), mvars, jnp.asarray(IDSB),
            pixel_values=jnp.asarray(PX), max_new_tokens=3,
            pad_lens=jnp.asarray(PADS)))
        states[mode] = flax_to_torch_llava(mvars)
        if mode != "f32":
            sh = infer_param_shardings(mvars["params"], mesh)
            want["placements"][mode] = {
                "/".join(str(getattr(p, "key", p)) for p in path):
                    (tuple(s.spec).index("model") if "model" in s.spec
                     else None)
                for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]}

    an_cfg = dataclasses.replace(cfg, image_grid_pinpoints=PINPOINTS)
    an_vars = {"params": dict(variables["params"])}
    an_vars["params"]["image_newline"] = np.zeros(
        (cfg.hidden,), np.float32) + 0.01
    img = (np.random.default_rng(6).random((40, 50, 3)) * 255).astype(
        np.uint8)
    tiles, hw = preprocess_anyres(img, PINPOINTS, an_cfg)
    vis = {k: an_vars["params"][k]
           for k in ("vision_tower", "mm_linear_1", "mm_linear_2")}
    feats = np.asarray(_VisionProject(an_cfg).apply({"params": vis},
                                                    jnp.asarray(tiles)))
    packed = pack_anyres_features(feats, hw, PINPOINTS, an_cfg,
                                  an_vars["params"]["image_newline"])
    ids = jnp.asarray([[1] + [60] * packed.shape[0] + [2, 3]], jnp.int32)
    want["anyres_packed"] = packed
    want["anyres_tokens"] = np.asarray(greedy_generate_llava(
        LlavaJax(an_cfg), an_vars, ids,
        image_features=jnp.asarray(packed)[None], max_new_tokens=3))
    states["anyres"] = flax_to_torch_llava(an_vars)
    return want, states, np.asarray(tiles), tuple(hw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    _, states, tiles, hw = jax_side
    return spawn(_tp_ranks, WORLD, tmp_path_factory.mktemp("tp"), states,
                 tiles, hw)


# ------------------------------------------------------------------ tests --

def test_tp_llava_forward_matches_jax(ranks, jax_side):
    """Path 4: the column-parallel model's logits == JAX's unsharded
    forward on every rank; the vision q/k/v, every LM projection and the
    LM head are the sharded layers (the rule's markers)."""
    for out in ranks:
        assert out["replaced"] == [
            "vision_tower.layers.0.self_attn.q_proj",
            "vision_tower.layers.0.self_attn.k_proj",
            "vision_tower.layers.0.self_attn.v_proj",
            "layers.0.self_attn.q_proj", "layers.0.self_attn.k_proj",
            "layers.0.self_attn.v_proj", "layers.0.self_attn.o_proj",
            "layers.0.gate_proj", "layers.0.up_proj", "layers.0.down_proj",
            "lm_head"]
        np.testing.assert_allclose(out["logits"], jax_side[0]["logits"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tp_padded_generate_matches_jax(ranks, jax_side, mode):
    """Paths 5-7: padded-batch greedy generate, f32, int8 and int4 (group
    8): the tokens of JAX's ``greedy_generate_llava`` on every rank."""
    for out in ranks:
        np.testing.assert_array_equal(out[f"tokens_{mode}"],
                                      jax_side[0][f"tokens_{mode}"])


def test_tp_anyres_generate_matches_jax(ranks, jax_side):
    """Path 11: tiles through the tensor-parallel vision tower, packed
    with the newline rows (more tokens than one tile's), then generate
    from ``image_features``."""
    want = jax_side[0]
    for out in ranks:
        assert out["anyres_packed"].shape[0] > (28 // 14) ** 2
        np.testing.assert_allclose(out["anyres_packed"],
                                   want["anyres_packed"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(out["anyres_tokens"],
                                      want["anyres_tokens"])


@pytest.fixture(scope="module")
def single_vla_step():
    return _vla_step()


def test_tp_tiny_vla_lora_step_matches_single(ranks, single_vla_step):
    """Path 3: the TinyVLA LoRA fine-tune with its projections, vision
    projection and LM head column-parallel == the single-process
    fine-tune: losses, and every tensor (each sharded one against its
    columns of the single model's)."""
    losses, _, want = single_vla_step
    for out in ranks:
        got_losses, replaced, state = out["vla"]
        assert len(replaced) == 9     # 7 projections, vision proj, head
        np.testing.assert_allclose(got_losses, losses, rtol=STEP_RTOL)
        idx = out["model_index"]
        for key, got in state.items():
            full = want[key.replace(".inner", "")]
            if got.shape != full.shape:
                dim = [a != b for a, b in zip(got.shape,
                                              full.shape)].index(True)
                full = full.chunk(2, dim)[idx]
            np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                                       atol=STEP_ATOL, err_msg=key)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_tp_sharding_matches_jax(ranks, jax_side, mode):
    """tests/test_quant.py's two placement tests: kernel_q shards by
    columns over the model axis, and its scales follow it (int8's (out,)
    along dim 0, int4's (G, out) along dim 1), on every LLaVA key as
    JAX's ``infer_param_shardings`` places it."""
    want = jax_side[0]["placements"][mode]
    for out in ranks:
        assert out["wide_model"] == 4
        got = {}
        for key, dim in out["placements"][mode].items():
            if dim is not None and key.endswith("/kernel"):
                dim = 1 - dim            # a torch weight is (out, in)
            got[key] = dim
        assert got == want
    gate = "layer_0/gate_proj/"
    assert want[gate + "kernel_q"] == 1
    assert want[gate + "kernel_scale"] == (0 if mode == "int8" else 1)
