"""The port's data- and tensor-parallel CNN fit (``Trainer(mesh=...)``,
training/train.py) against its single-process fit, the counterpart of
tests/test_training.py:145.

The mesh fit computes what the single-process fit computes at the same
global batch, the sums in another order, so: one train step (both
attention gates, "hybrid") with its loss, gradients and BatchNorm
running statistics within 1e-5 relative of the single step's (each
tensor's gradient against its norm), and the weights after it within
1e-5; a two-epoch fit of the default (spatial-gate) model with its
training losses within 1e-5 relative, epoch by epoch; on a (2, 1) and a
(2, 2) mesh. Rounding differences grow over a fit (Adam normalises
near-zero gradients), faster with both gates, so the fit is held on the
default model.

The biases that feed a train-mode BatchNorm have an exact gradient of
0; Adam turns the rounding noise that stands for it into steps of the
learning rate with the noise's sign, so those biases are held at their
gradients only (absolutely), and the validation loss, which reads the
running means they shift, at 1e-3.
Gloo CPU ranks: two for the (2, 1) mesh, four for (2, 2).
"""

import numpy as np
import pytest
import torch

from tests._torch_dist import spawn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = ((2, 1), (2, 2))
EPOCHS = 2
BATCH = 8
REL = 1e-5


def _configs(attention="spatial"):
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    return (ModelConfig(encoder_filters=(8, 16), attention_type=attention),
            TrainConfig(batch_size=BATCH))


def _dataset(n=48, p=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    depth = rng.normal(size=(n, p, p)).astype(np.float32) \
        + labels[:, None, None]
    return dict(depth_patches=depth,
                mask_patches=(rng.random((n, p, p)) > 0.5).astype(
                    np.float32),
                score_patches=rng.normal(size=(n, 7, p, p)).astype(
                    np.float32),
                labels=labels)


def _step_inputs():
    rng = np.random.default_rng(1)
    feats = torch.as_tensor(rng.normal(size=(BATCH, 16, 16, 9))
                            .astype(np.float32))
    labels = torch.as_tensor((rng.random(BATCH) > 0.5).astype(np.float32))
    return feats, labels


def _one_step(model, step, rows):
    """One seeded train step on this rank's rows of the fixed batch:
    (loss, {name: grad}, {name: BatchNorm running stat})."""
    feats, labels = _step_inputs()
    torch.manual_seed(3)
    loss, _ = step(feats[rows], labels[rows],
                   torch.ones(rows.stop - rows.start), 2.0)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if "running" in n}
    return float(loss), grads, stats


def _initial_model():
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_like_flax_)
    return init_like_flax_(GraspPointCNN(_configs("hybrid")[0]),
                           torch.Generator().manual_seed(0))


def _train_ranks(rank, world):
    from leafgrasp_tpu_torch.parallel import make_mesh
    from leafgrasp_tpu_torch.parallel.collectives import Axis
    from leafgrasp_tpu_torch.training.train import (
        Trainer, gather_grasp_cnn, make_optimizer, make_parallel_train_step,
        parallelize_grasp_cnn)

    model_cfg, train_cfg = _configs("hybrid")
    data, model_axis = next(m for m in MESHES if m[0] * m[1] == world)
    mesh = make_mesh(world, model_axis=model_axis, device="cpu")
    model, sharded, rows = parallelize_grasp_cnn(_initial_model(), mesh,
                                                 BATCH)
    step = make_parallel_train_step(model, make_optimizer(model, train_cfg),
                                    train_cfg, mesh, sharded)
    loss, grads, stats = _one_step(model, step, rows)
    tp = Axis(mesh, "model")
    grads = {k: torch.cat(list(tp.gather(g))) if k in sharded else g
             for k, g in grads.items()}
    plain = gather_grasp_cnn(model, mesh, sharded, model_cfg)
    res = Trainer(*_configs(), mesh=mesh).fit(_dataset(), epochs=EPOCHS)
    out = dict(loss=loss, grads=grads, stats=stats, sharded=sorted(sharded),
               stepped=plain.state_dict(),
               history={k: res.history[k] for k in ("train_loss",
                                                    "val_loss")},
               weights=res.model.state_dict())
    try:
        Trainer(model_cfg, train_cfg, device="meta", mesh=mesh)
        out["device_check"] = None
    except (ValueError, RuntimeError) as exc:
        out["device_check"] = type(exc).__name__
    return out


@pytest.fixture(scope="module")
def single():
    from leafgrasp_tpu_torch.training.train import (Trainer, make_optimizer,
                                                    make_train_step)
    from leafgrasp_tpu_torch.models.grasp_cnn import batchnorm_fed_biases
    model = _initial_model()
    train_cfg = _configs("hybrid")[1]
    step = make_train_step(model, make_optimizer(model, train_cfg),
                           train_cfg)
    loss, grads, stats = _one_step(model, step, slice(0, BATCH))
    res = Trainer(*_configs(), device="cpu").fit(_dataset(), epochs=EPOCHS)
    return dict(loss=loss, grads=grads, stats=stats,
                stepped=model.state_dict(), history=res.history,
                bn_fed=batchnorm_fed_biases(model))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> each rank's results: 2 ranks for (2, 1), 4 for (2, 2)."""
    return {mesh: spawn(_train_ranks, mesh[0] * mesh[1],
                        tmp_path_factory.mktemp("fit"))
            for mesh in MESHES}


def _rel(got, want):
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def _by_mesh(ranks, mesh):
    return ranks[mesh]


@pytest.mark.parametrize("mesh", MESHES)
def test_one_step_matches_single(ranks, single, mesh):
    for out in _by_mesh(ranks, mesh):
        assert abs(out["loss"] - single["loss"]) <= REL * abs(single["loss"])
        for name, want in single["grads"].items():
            got = out["grads"][name]
            err = float((got - want).norm() / max(want.norm(), 1e-30))
            # exact 0 gradients (BatchNorm-fed biases) compare absolutely
            assert err <= REL or float((got - want).abs().max()) < 1e-7, \
                (name, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_batchnorm_statistics_are_the_global_batch(ranks, single, mesh):
    for out in _by_mesh(ranks, mesh):
        assert out["stats"].keys() == single["stats"].keys()
        for name, want in single["stats"].items():
            assert _rel(out["stats"][name], want) <= REL, name


@pytest.mark.parametrize("mesh", MESHES)
def test_stepped_weights_match_single(ranks, single, mesh):
    for out in _by_mesh(ranks, mesh):
        for name, want in single["stepped"].items():
            if want.dtype.is_floating_point \
                    and name not in single["bn_fed"]:
                np.testing.assert_allclose(out["stepped"][name].numpy(),
                                           want.numpy(), rtol=0,
                                           atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_fit_losses_match_single(ranks, single, mesh):
    want = single["history"]
    for out in _by_mesh(ranks, mesh):
        np.testing.assert_allclose(out["history"]["train_loss"],
                                   want["train_loss"], rtol=REL, atol=0)
        np.testing.assert_allclose(out["history"]["val_loss"],
                                   want["val_loss"], rtol=1e-3, atol=0)


def test_tensor_parallel_shards_the_dense_layers(ranks):
    out = _by_mesh(ranks, (2, 2))[0]
    assert out["sharded"] == [f"dense.{i}.{leaf}" for i in range(3)
                              for leaf in ("bias", "weight")]
    assert _by_mesh(ranks, (2, 1))[0]["sharded"] == []


def test_every_rank_returns_the_full_weights(ranks):
    for mesh in MESHES:
        outs = _by_mesh(ranks, mesh)
        for out in outs[1:]:
            for name, t in outs[0]["weights"].items():
                assert torch.equal(out["weights"][name], t), name


def test_mesh_trainer_checks_its_device(ranks):
    for outs in ranks.values():
        for out in outs:
            assert out["device_check"] == "ValueError"
