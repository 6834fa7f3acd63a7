"""The port's trainer, gate gradient, optimizer, checkpoints and sweeps
against the JAX package, on the CPU at small sizes ((8, 16) filters).

Tolerances, each with its reason:
* loss, metrics and normalization stats: 1e-6 absolute (f32 sums in
  another order); the train step's loss 1e-5 relative (four convolution
  layers and six BatchNorm layers in f32 before it);
* the gate's gradient: dx 1e-5 absolute, each parameter gradient's
  largest difference 1e-5 of its L2 norm (f32, other orders);
* one train step's gradient tree: each leaf as close to the float64
  gradient as JAX's (a factor 2 plus 5e-6 of its norm), and within 2e-4
  of JAX's leaf's norm (f32 gradients of this network sit up to ~1e-4 of
  a leaf's norm from the float64 one, in both frameworks), except the
  biases that feed a train-mode BatchNorm, whose exact gradient is 0 (the
  batch mean cancels them) and whose computed one is rounding noise on
  both sides: they are held to 1e-5 of the norm of the same layer's
  weight gradient;
* batch statistics after the step: 1e-6 absolute;
* the optimizer fed JAX's gradients, against ``tx.update``: parameters
  within 1e-6 absolute after each of 3 steps (the same gradients go in,
  so Adam's first-step sign amplification of a gradient's rounding stays
  out of the comparison);
* logits of the converted JAX checkpoint: 1e-5 absolute.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leafgrasp_tpu.config import ModelConfig as JModelConfig
from leafgrasp_tpu.config import TrainConfig as JTrainConfig
from leafgrasp_tpu.models.attention_pallas import attention_gate_reference
from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
from leafgrasp_tpu.training import experiments as jexp
from leafgrasp_tpu.training import train as jtrain
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
from leafgrasp_tpu_torch.kernels.attention import (
    MODES, attention_gate_backward, attention_gate_backward_plain,
    attention_gate_plain, fused_attention_gate)
from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                  batchnorm_fed_biases,
                                                  init_like_flax_)
from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
from leafgrasp_tpu_torch.training import (ExperimentTracker, Trainer,
                                          analyze_predictions,
                                          bce_with_logits,
                                          generate_experiment_configs,
                                          load_checkpoint,
                                          normalize_dataset, run_sweep,
                                          save_checkpoint)
from leafgrasp_tpu_torch.training.checkpoint import best_model_path
from leafgrasp_tpu_torch.training.train import (PlateauSchedule,
                                                make_optimizer,
                                                optimizer_step)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(encoder_filters=(8, 16), conv_dropout=0.0,
             fc_dropout=(0.0, 0.0, 0.0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _max_rel(got, want) -> float:
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    norm = float(np.linalg.norm(np.asarray(want)))
    return err / norm if norm > 0 else (0.0 if err == 0 else np.inf)


def _synthetic_dataset(n=64, seed=0):
    """Separable toy set: positives have a bright center blob (the JAX
    package's tests/test_training.py:_synthetic_dataset)."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) > 0.45).astype(np.int32)
    depth = rng.normal(0.5, 0.05, (n, 32, 32)).astype(np.float32)
    maskp = np.ones((n, 32, 32), np.float32)
    scorep = rng.normal(0, 0.3, (n, 7, 32, 32)).astype(np.float32)
    for i in range(n):
        if labels[i]:
            scorep[i, :, 12:20, 12:20] += 2.0
    return {"depth_patches": depth, "mask_patches": maskp,
            "score_patches": scorep, "labels": labels}


# ------------------------------------------------------ loss and metrics --

@pytest.mark.parametrize("masked", [False, True])
def test_bce_with_logits_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, 40).astype(np.float32)
    labels = (rng.random(40) > 0.5).astype(np.float32)
    mask = (rng.random(40) > 0.3).astype(np.float32) if masked else None
    want = float(jtrain.bce_with_logits(
        jnp.asarray(logits), jnp.asarray(labels), 2.0,
        None if mask is None else jnp.asarray(mask)))
    got = float(bce_with_logits(
        torch.from_numpy(logits), torch.from_numpy(labels), 2.0,
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_analyze_predictions_matches_jax(threshold):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, 50).astype(np.float32)
    labels = (rng.random(50) > 0.5).astype(np.float32)
    assert analyze_predictions(logits, labels, threshold) \
        == jtrain.analyze_predictions(logits, labels, threshold)


def test_normalize_dataset_matches_jax():
    """Stats within 1e-6 of JAX's; the normalized values within 1e-6 of
    the float64 computation. JAX's own f32 mean on the CPU is 3.7e-7 off
    the exact one here (7 ulps; torch's is correctly rounded), which the
    division by the depth's 0.05 spread turns into 7e-6 in its normalized
    values, so those are held to JAX's at 1e-5."""
    ds = _synthetic_dataset(24)
    jd, js, jstats = jtrain.normalize_dataset(
        jnp.asarray(ds["depth_patches"]), jnp.asarray(ds["score_patches"]))
    td, ts, tstats = normalize_dataset(torch.from_numpy(ds["depth_patches"]),
                                       torch.from_numpy(ds["score_patches"]))
    for got, want in zip(tstats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    d64 = ds["depth_patches"].astype(np.float64)
    s64 = ds["score_patches"].astype(np.float64)
    exact_d = (d64 - d64.mean()) / d64.std()
    exact_s = (s64 - s64.mean(axis=(0, 2, 3), keepdims=True)) \
        / s64.std(axis=(0, 2, 3), keepdims=True)
    for got, exact, want in [(td, exact_d, jd), (ts, exact_s, js)]:
        np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------- gate gradient --

@pytest.mark.parametrize("dy_form", ["contiguous", "pool_stride0"])
@pytest.mark.parametrize("mode", MODES)
def test_gate_backward_plain_matches_jax_grad(mode, dy_form):
    n, h, w, c, r = 4, 4, 4, 48, 3
    rng = np.random.default_rng(11)
    x = np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)
    params = [rng.standard_normal(s).astype(np.float32) * 0.4
              for s in [(c, 1), (1,), (c, r), (r,), (r, c), (c,)]]
    if dy_form == "contiguous":
        dy = rng.standard_normal((n, h * w, c)).astype(np.float32)
        dy_t = torch.from_numpy(dy)
    else:   # the average pool's gradient: stride 0 along HW
        pooled = rng.standard_normal((n, 1, c)).astype(np.float32) / (h * w)
        dy = np.broadcast_to(pooled, (n, h * w, c))
        dy_t = torch.from_numpy(pooled).expand(n, h * w, c)
        assert dy_t.stride()[1] == 0
    _, vjp = jax.vjp(lambda xx, *p: attention_gate_reference(
        xx, *p, mode), jnp.asarray(x), *map(jnp.asarray, params))
    want = vjp(jnp.asarray(np.ascontiguousarray(dy)).reshape(n, h, w, c))
    x_t = torch.from_numpy(x).reshape(n, h * w, c)
    got = attention_gate_backward_plain(
        dy_t, x_t, *map(torch.from_numpy, params), mode)
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(want[0]).reshape(n, h * w, c),
                               rtol=0, atol=1e-5)
    for g, wnt in zip(got[1:], want[1:]):
        assert g.shape == wnt.shape
        assert _max_rel(g.numpy(), wnt) <= 1e-5
    # the CPU wrapper is the plain version
    again = attention_gate_backward(dy_t, x_t, *map(torch.from_numpy,
                                                    params), mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("mode", MODES)
def test_gate_backward_plain_matches_autograd(mode):
    """float64, so the two differ only by the last bits."""
    n, hw, c, r = 3, 9, 20, 4
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((n, hw, c), generator=gen, dtype=torch.float64)
    params = [torch.randn(s, generator=gen, dtype=torch.float64) * 0.4
              for s in [(c, 1), (1,), (c, r), (r,), (r, c), (c,)]]
    dy = torch.randn((n, hw, c), generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    out = fused_attention_gate(*leaves, mode)      # CPU: plain, autograd
    want = torch.autograd.grad(out, leaves, dy, allow_unused=True)
    got = attention_gate_backward_plain(dy, x, *params, mode)
    for g, wnt in zip(got, want):
        wnt = torch.zeros_like(g) if wnt is None else wnt
        torch.testing.assert_close(g, wnt, rtol=0, atol=1e-12)
    assert torch.equal(attention_gate_plain(x, *params, mode),
                       out.detach())


# ------------------------------------------------------------- one step --

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


@pytest.fixture(scope="module", params=["spatial", "channel", "hybrid",
                                        "none"])
def one_step(request):
    """One train step of a small CNN from the same (converted) weights
    and batch (the trainer's 16) in JAX and in the port, dropout 0."""
    attention = request.param
    jcfg = JModelConfig(attention_type=attention, **SMALL)
    model, variables = init_grasp_cnn(jax.random.PRNGKey(0), jcfg)
    variables = _randomize(variables, seed=5)
    rng = np.random.default_rng(9)
    bs = TrainConfig().batch_size
    x = rng.normal(size=(bs, 32, 32, 9)).astype(np.float32)
    labels = (rng.random(bs) > 0.5).astype(np.float32)
    mask = np.ones(bs, np.float32)

    def loss_fn(p):
        logits, mutated = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True,
            rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        loss = jtrain.bce_with_logits(logits, jnp.asarray(labels), 2.0,
                                      jnp.asarray(mask))
        return loss, mutated["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    ports = {}
    for dtype in (torch.float32, torch.float64):
        port = GraspPointCNN(ModelConfig(attention_type=attention, **SMALL))
        port.load_state_dict(flax_to_torch_grasp_cnn(_np_tree(variables)))
        port.to(dtype).train()
        t_loss = bce_with_logits(port(torch.from_numpy(x).to(dtype)),
                                 torch.from_numpy(labels).to(dtype), 2.0,
                                 torch.from_numpy(mask).to(dtype))
        t_loss.backward()
        ports[dtype] = (port, t_loss.item())
    want = flax_to_torch_grasp_cnn(_np_tree({"params": grads,
                                             "batch_stats": new_bs}))
    port, port_loss = ports[torch.float32]
    exact = {k: p.grad.numpy() for k, p in
             ports[torch.float64][0].named_parameters()}
    return dict(jax_loss=float(loss), port_loss=port_loss, want=want,
                port=port, exact=exact, variables=variables, grads=grads)


def test_train_step_loss_and_gradients_match_jax(one_step):
    """Each leaf's f32 gradient is as close to the float64 gradient (the
    port's own, in double precision) as JAX's f32 gradient is, within a
    factor 2 and 5e-6 of the norm: in f32 both sit up to ~1e-4 of a
    leaf's norm from it (the spatial gate's bias; ~1e-5 for most leaves),
    so 1e-5 between the two f32 trees is out of reach of any f32 order of
    sums. Directly, the two trees agree within 2e-4 of each leaf's norm.
    The biases that feed a train-mode BatchNorm (exact gradient 0): within
    1e-5 of the same layer's weight-gradient norm."""
    assert abs(one_step["port_loss"] - one_step["jax_loss"]) \
        <= 1e-5 * abs(one_step["jax_loss"])
    want, port, exact = one_step["want"], one_step["port"], one_step["exact"]
    names = [k for k, _ in port.named_parameters()]
    assert names and all(port.get_parameter(k).grad is not None
                         for k in names)
    for k in names:
        got = port.get_parameter(k).grad.numpy()
        if k in batchnorm_fed_biases(port):
            ref = want[k[:-len("bias")] + "weight"].numpy()
            err = float(np.abs(got - want[k].numpy()).max())
            assert err <= 1e-5 * np.linalg.norm(ref), k
            continue
        assert _max_rel(got, want[k].numpy()) <= 2e-4, k
        assert _max_rel(got, exact[k]) \
            <= 2.0 * _max_rel(want[k].numpy(), exact[k]) + 5e-6, k


def test_train_step_batch_stats_match_jax(one_step):
    want, port = one_step["want"], one_step["port"]
    stats = {k: v for k, v in port.state_dict().items()
             if k.endswith("running_mean") or k.endswith("running_var")}
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_optimizer_matches_optax_for_three_steps(one_step):
    """The port's clip + Adam(weight_decay) fed JAX's gradients (the
    step's, then scaled copies, one clipped and one not; the learning
    rate halves before step 3 as the plateau cut does) against optax's
    ``tx.update`` from ``make_optimizer``."""
    cfg = TrainConfig()
    params = one_step["variables"]["params"]
    port = GraspPointCNN(ModelConfig(attention_type=one_step["port"]
                                     .attention.mode, **SMALL))
    port.load_state_dict(flax_to_torch_grasp_cnn(
        _np_tree(one_step["variables"])))
    opt = make_optimizer(port, TrainConfig())
    tx = jtrain.make_optimizer(JTrainConfig())
    state = tx.init(params)
    plist = list(port.parameters())
    for i, scale in enumerate((1.0, 40.0, 0.01)):
        grads = jax.tree.map(lambda g: g * scale, one_step["grads"])
        if i == 2:
            state.hyperparams["learning_rate"] = jnp.asarray(
                cfg.learning_rate * 0.5, jnp.float32)
            for group in opt.param_groups:
                group["lr"] = cfg.learning_rate * 0.5
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        conv = flax_to_torch_grasp_cnn(_np_tree(
            {"params": grads,
             "batch_stats": one_step["variables"]["batch_stats"]}))
        for k, p in port.named_parameters():
            p.grad = conv[k].clone()
        optimizer_step(opt, plist, cfg)
        want = flax_to_torch_grasp_cnn(_np_tree(
            {"params": params,
             "batch_stats": one_step["variables"]["batch_stats"]}))
        for k, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {i}: {k}")


# ---------------------------------------------------- schedule and init --

def test_plateau_and_early_stop_schedule():
    """JAX's loop (train.py:307-329) on a fixed loss sequence: strict <
    against the best, a cut once the wait passes the patience, the wait
    restarting after a cut, early stop on min_delta. torch's
    ReduceLROnPlateau would treat 0.99995 as no gain (relative threshold
    1e-4) and cut one epoch earlier."""
    cfg = TrainConfig(learning_rate=1e-3, plateau_patience=2,
                      plateau_factor=0.5, min_lr=3e-4,
                      early_stop_patience=6, early_stop_min_delta=0.01)
    losses = [1.0, 0.99995, 1.2, 1.2, 1.1, 1.3, 0.98, 0.975, 0.99] \
        + [1.5] * 9
    sched = PlateauSchedule(cfg)
    lrs, improved, stops = [], [], []
    for v in losses:
        lrs.append(sched.lr)
        imp, stop = sched.step(v)
        improved.append(imp)
        stops.append(stop)
        if stop:
            break
    assert improved == [True, True, False, False, False, False, True, True,
                        False, False, False, False, False]
    assert lrs == [1e-3] * 5 + [5e-4] * 6 + [3e-4] * 2
    assert stops == [False] * 12 + [True]
    # past the floor the cut stays at min_lr
    sched = PlateauSchedule(dataclasses.replace(cfg, early_stop_patience=99))
    for v in [1.0] + [2.0] * 12:
        sched.step(v)
    assert sched.lr == 3e-4


def test_init_like_flax_moments():
    """Each weight's spread within 5% of Flax's initializers' (tensors of
    4096 and more values, so the sample spread is itself within ~1.5%),
    truncation at two standard deviations, exact zeros and ones."""
    jcfg = JModelConfig(attention_type="hybrid", encoder_filters=(128, 256,
                                                                  512))
    _, variables = init_grasp_cnn(jax.random.PRNGKey(3), jcfg)
    want = flax_to_torch_grasp_cnn(_np_tree(variables))
    port = init_like_flax_(GraspPointCNN(ModelConfig(
        attention_type="hybrid", encoder_filters=(128, 256, 512))),
        torch.Generator().manual_seed(0))
    got = port.state_dict()
    checked = 0
    for k, w in want.items():
        g = got[k].numpy().astype(np.float64)
        w = w.numpy().astype(np.float64)
        if w.ndim < 2:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size >= 4096:
            assert abs(g.std() / w.std() - 1.0) < 0.05, k
            assert abs(g.mean()) < 0.05 * w.std(), k
            assert np.abs(g).max() <= np.abs(w).max() * 1.05, k
            checked += 1
    assert checked >= 10


def test_trainer_learns_separable_toy():
    """Mirrors tests/test_training.py::test_trainer_learns_separable_toy
    (dropout off: optimization mechanics, not regularization noise)."""
    trainer = Trainer(ModelConfig(encoder_filters=(8, 16),
                                  attention_type="spatial",
                                  conv_dropout=0.0,
                                  fc_dropout=(0.0, 0.0, 0.0)),
                      TrainConfig(batch_size=16, learning_rate=1e-3),
                      device="cpu")
    res = trainer.fit(_synthetic_dataset(96), epochs=15)
    assert res.best_val_loss < 1.1
    assert min(res.history["train_loss"][-3:]) \
        < res.history["train_loss"][0] * 0.8
    assert res.best_val_loss == min(res.history["val_loss"])
    assert res.history["val_loss"][res.best_epoch] == res.best_val_loss


def test_trainer_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer()


# ------------------------------------------------------ sweeps and files --

def test_sweep_configs_equal_jax():
    got = generate_experiment_configs()
    want = jexp.generate_experiment_configs()
    assert [dataclasses.asdict(c) for c in got] \
        == [dataclasses.asdict(c) for c in want]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g.model_config()) \
            == dataclasses.asdict(w.model_config())
        assert dataclasses.asdict(g.train_config()) \
            == dataclasses.asdict(w.train_config())


def test_sweep_runs_and_ranks(tmp_path):
    tracker = ExperimentTracker(str(tmp_path))
    configs = [c for c in generate_experiment_configs()
               if c.architecture == "lightweight"][:2]
    run_sweep(_synthetic_dataset(48), tracker, configs=configs, epochs=2,
              device="cpu")
    runs = tracker.runs()
    assert [r["run"] for r in runs] == [c.name for c in configs]
    assert all(len(r["epochs"]) == 2 for r in runs)
    top = tracker.top_k(1)[0]
    assert top["final"]["f1_score"] == max(r["final"]["f1_score"]
                                           for r in runs)
    assert os.path.exists(tracker.write_summary())


def test_checkpoint_roundtrip_and_predictor(tmp_path):
    trainer = Trainer(ModelConfig(**SMALL), TrainConfig(batch_size=8),
                      device="cpu")
    res = trainer.fit(_synthetic_dataset(32), epochs=2)
    path = save_checkpoint(best_model_path(str(tmp_path)),
                           res.model.state_dict(),
                           optimizer_state=res.optimizer_state,
                           norm_stats=res.norm_stats, metrics=res.metrics,
                           history=res.history, epoch=res.best_epoch)
    assert path == str(tmp_path / "best_model")
    restored = load_checkpoint(path)
    assert restored["epoch"] == res.best_epoch
    assert restored["meta"]["metrics"]["f1_score"] \
        == res.metrics["f1_score"]
    assert set(restored["meta"]["history"]) == {"train_loss", "val_loss",
                                                "lr"}
    for k, v in res.model.state_dict().items():
        assert torch.equal(restored["state_dict"][k], v), k
    for k in ("depth_mean", "depth_std", "score_mean", "score_std"):
        np.testing.assert_array_equal(restored["norm_stats"][k],
                                      getattr(res.norm_stats, k).numpy())
    opt = make_optimizer(GraspPointCNN(ModelConfig(**SMALL)), TrainConfig())
    opt.load_state_dict(restored["optimizer_state"])

    pred = GraspQualityPredictor(ModelConfig(**SMALL), device="cpu") \
        .load(path)
    x = np.random.default_rng(0).normal(size=(5, 32, 32, 9)) \
        .astype(np.float32)
    with torch.no_grad():
        want = torch.sigmoid(res.model.eval()(torch.from_numpy(x))) \
            .reshape(-1).numpy()
    np.testing.assert_array_equal(pred.predict_batch(x), want)
    assert set(pred.norm_stats) == {"depth_mean", "depth_std",
                                    "score_mean", "score_std"}
    # a bare state_dict still loads, and carries no stats
    bare = tmp_path / "bare.pt"
    torch.save(res.model.state_dict(), bare)
    pred.load(str(bare))
    assert pred.norm_stats is None


def test_orbax_checkpoint_converts_to_the_port(tmp_path):
    """tools/grasp_cnn_from_orbax.py on the stored JAX checkpoint:
    the port's logits against the JAX model's on 32 patches of the stored
    corpus, normalized with the checkpoint's own stats (1e-5 absolute)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import grasp_cnn_from_orbax as tool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    src = ROOT / "artifacts" / "grasp_cnn_hard" / "best_model"
    out = tool.convert(str(src), str(tmp_path / "best_model"))
    restored = tool.restore_on_cpu(str(src))
    cfg = tool.model_config_from_params(_np_tree(restored["params"]))
    jmodel, _ = init_grasp_cnn(jax.random.PRNGKey(0), JModelConfig(
        attention_type=cfg.attention_type,
        encoder_filters=cfg.encoder_filters))
    data = np.load(ROOT / "artifacts" / "grasp_cnn_hard" / "training_data"
                   / "training_data.npz")
    ns = restored["norm_stats"]
    depth = (data["depth_patches"][:32] - ns["depth_mean"]) / ns["depth_std"]
    score = (data["score_patches"][:32]
             - ns["score_mean"].reshape(1, 7, 1, 1)) \
        / ns["score_std"].reshape(1, 7, 1, 1)
    feats = np.concatenate([depth[..., None],
                            data["mask_patches"][:32][..., None],
                            np.moveaxis(score, 1, -1)], -1).astype(np.float32)
    want = np.asarray(jmodel.apply(
        {"params": restored["params"],
         "batch_stats": restored["batch_stats"]}, feats, train=False))
    pred = GraspQualityPredictor(cfg, device="cpu").load(out)
    with torch.no_grad():
        got = pred.model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for k in ("depth_mean", "depth_std", "score_mean", "score_std"):
        np.testing.assert_array_equal(pred.norm_stats[k],
                                      np.asarray(ns[k], np.float32))
    meta = json.loads(Path(out + ".meta.json").read_text())
    assert meta["epoch"] == 32


def test_training_demo_runs_on_the_cpu(tmp_path, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "run_training_demo_torch",
        ROOT / "examples" / "run_training_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    report = demo.main(["--device", "cpu", "--frames", "3", "--epochs", "2",
                        "--out", str(tmp_path), "--small"])
    assert report["samples"] > 0 and report["checkpoint"]
    assert os.path.exists(report["checkpoint"])
    assert "val_loss" in capsys.readouterr().out


def test_training_modules_import_no_jax():
    """Importing the port's training stack (and everything it imports)
    loads none of jax, flax, optax, orbax or the JAX package."""
    code = ("import sys, leafgrasp_tpu_torch.training, "
            "leafgrasp_tpu_torch.models.predictor; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "{'jax', 'flax', 'optax', 'orbax', 'leafgrasp_tpu'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
