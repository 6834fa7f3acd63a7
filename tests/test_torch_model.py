"""The port's GraspPointCNN against the Flax model, with weights carried
over by ``flax_to_torch_grasp_cnn``.

Logits compare within 1e-4 absolute: the convolutions sum in another
order in each framework. Every parameter and BatchNorm statistic is
replaced by seeded noise first, so no weight mapping can hide behind a
zero or a one.
"""

import os

import numpy as np
import pytest
import torch

import jax

from leafgrasp_tpu.config import ModelConfig as JModelConfig
from leafgrasp_tpu.models.grasp_cnn import ARCHITECTURES as J_ARCHS
from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
from leafgrasp_tpu.models.grasp_cnn import ml_scores_from_logits as j_ml
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.config import ModelConfig
from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
from leafgrasp_tpu_torch.models.grasp_cnn import (ARCHITECTURES,
                                                  GraspPointCNN,
                                                  init_random_,
                                                  ml_scores_from_logits)

LOGIT_TOL = 1e-4
CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "grasp_cnn", "best_model")


def _randomize(variables, seed):
    """Seeded noise in place of every leaf (BatchNorm variances > 0)."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "var" in name:
            val = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            val = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        else:
            val = rng.normal(0.0, 0.2, shape) + ("scale" in name)
        leaves.append(val.astype(np.float32))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables), leaves)


def _port_model(cfg_kw, variables):
    model = GraspPointCNN(ModelConfig(**cfg_kw)).eval()
    model.load_state_dict(flax_to_torch_grasp_cnn(
        jax.tree.map(np.asarray, variables)))
    return model


def test_architectures_match_jax():
    assert ARCHITECTURES == J_ARCHS


@pytest.mark.parametrize("attention", ["none", "spatial", "channel",
                                       "hybrid"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_logits_match_flax(arch, attention):
    cfg_kw = dict(encoder_filters=ARCHITECTURES[arch],
                  attention_type=attention)
    model, variables = init_grasp_cnn(jax.random.PRNGKey(0),
                                      JModelConfig(**cfg_kw))
    variables = _randomize(variables, seed=len(arch) + len(attention))
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 9)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, x))
    port = _port_model(cfg_kw, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(ml_scores_from_logits(torch.from_numpy(got))
                               .numpy(), np.asarray(j_ml(got)), atol=1e-6)
    # same parameter count as the Flax tree (unused gates hold none)
    n_flax = sum(np.size(p) for p in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_flax


def test_convert_maps_every_tensor():
    cfg = JModelConfig(encoder_filters=(8, 16), attention_type="hybrid")
    _, variables = init_grasp_cnn(jax.random.PRNGKey(2), cfg)
    sd = flax_to_torch_grasp_cnn(jax.tree.map(np.asarray, variables))
    port = GraspPointCNN(ModelConfig(encoder_filters=(8, 16),
                                     attention_type="hybrid"))
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    conv = np.asarray(variables["params"]["_EncoderBlock_0"]["Conv_0"]
                      ["kernel"])                                  # HWIO
    np.testing.assert_array_equal(sd["blocks.0.conv0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))


def test_init_random_is_seeded():
    a = init_random_(GraspPointCNN(ModelConfig()), seed=4).state_dict()
    b = init_random_(GraspPointCNN(ModelConfig()), seed=4).state_dict()
    c = init_random_(GraspPointCNN(ModelConfig()), seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.conv0.weight"],
                           c["blocks.0.conv0.weight"])


def test_trained_checkpoint_logits_match_flax():
    """The trained weights in artifacts/ go through the converter: the
    port's logits hold to Flax's on a seeded patch batch."""
    from leafgrasp_tpu.models.grasp_cnn import GraspPointCNN as FlaxCNN
    from leafgrasp_tpu.training.checkpoint import load_checkpoint
    restored = load_checkpoint(CKPT)
    variables = {"params": restored["params"],
                 "batch_stats": restored["batch_stats"]}
    params = restored["params"]
    n_blocks = sum(k.startswith("_EncoderBlock_") for k in params)
    filters = tuple(int(np.shape(params[f"_EncoderBlock_{b}"]["Conv_0"]
                                 ["kernel"])[-1]) for b in range(n_blocks))
    att = params.get("attention", {})
    attention = {(True, True): "hybrid", (True, False): "spatial",
                 (False, True): "channel", (False, False): "none"}[
        ("spatial_kernel" in att, "squeeze_kernel" in att)]
    cfg_kw = dict(encoder_filters=filters, attention_type=attention)
    x = np.random.default_rng(11).normal(size=(20, 32, 32, 9)) \
        .astype(np.float32)
    want = np.asarray(FlaxCNN(JModelConfig(**cfg_kw)).apply(
        variables, x, train=False))
    with torch.no_grad():
        got = _port_model(cfg_kw, variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
