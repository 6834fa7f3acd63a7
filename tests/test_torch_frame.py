"""The port's whole per-frame path (``make_frame_fn``) against the JAX
package's, on the three ``bench.py`` scene families scaled to 360x480
(one third: margins divided by three, leaf counts and seeds kept), in
the ``union`` and ``reference_self`` isolation modes, with and without
the CNN (the same Flax weights, converted).

Leaf id, candidate pixels and grasp pixel compare bit-exact; the 3D
grasp and the fused scores at f32 tolerance.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from leafgrasp_tpu.io.scenes import make_leaf_scene
from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
from leafgrasp_tpu.pipeline.frame import make_frame_fn as j_make_frame_fn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
from leafgrasp_tpu_torch.utils import device as tdevice

H, W = 360, 480
CX, CY, F = (np.float32(v / 3) for v in (707.87, 494.07, 1750.68))
# bench.py:37-41 at one third of 1080 x 1440
FAMILIES = {"sparse": (6, 8, 40), "crowded": (12, 3, 20),
            "large_leaf": (3, 5, 87)}
MODES = ("union", "reference_self")


@functools.lru_cache(maxsize=None)
def _scene(family):
    n, seed, margin = FAMILIES[family]
    return make_leaf_scene(H, W, num_leaves=n, seed=seed, margin=margin)


@functools.lru_cache(maxsize=None)
def _weights():
    _, variables = init_grasp_cnn(jax.random.PRNGKey(0),
                                  jcfg.DEFAULT_CONFIG.model)
    model = GraspPointCNN(tcfg.ModelConfig()).eval()
    model.load_state_dict(flax_to_torch_grasp_cnn(
        jax.tree.map(np.asarray, variables)))
    return variables, model


@functools.lru_cache(maxsize=None)
def _frame_fns(mode, with_cnn):
    jc = jcfg.DEFAULT_CONFIG.replace(
        grasp=jcfg.GraspScoringConfig(isolation_context=mode))
    tc = tcfg.DEFAULT_CONFIG.replace(
        grasp=tcfg.GraspScoringConfig(isolation_context=mode))
    return (j_make_frame_fn(jc, with_cnn=with_cnn),
            make_frame_fn(tc, with_cnn=with_cnn, device="cpu"))


def _assert_same_frame(a, b):
    assert int(a.leaf_id) == int(b.leaf_id)
    np.testing.assert_array_equal(np.asarray(a.grasp_uv), b.grasp_uv.numpy())
    for name in ("x", "y", "accepted"):
        np.testing.assert_array_equal(np.asarray(getattr(a.candidates, name)),
                                      getattr(b.candidates, name).numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(a.candidates.score),
                               b.candidates.score.numpy(), rtol=0, atol=1e-5)
    for name in ("found", "degenerate", "ml_used"):
        assert bool(getattr(a, name)) == bool(getattr(b, name)), name
    np.testing.assert_allclose(np.asarray(a.grasp_xyz), b.grasp_xyz.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.pre_grasp_xyz),
                               b.pre_grasp_xyz.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.fusion.combined),
                               b.fusion.combined.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_cnn", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_frame_matches_jax(family, mode, with_cnn):
    mask, depth = _scene(family)
    jfn, tfn = _frame_fns(mode, with_cnn)
    args = (mask, depth, CX, CY, F)
    kernels.reset_launch_counts()
    if with_cnn:
        variables, model = _weights()
        a, b = jfn(*args, variables), tfn(*args, model)
    else:
        a, b = jfn(*args), tfn(*args)
    assert not bool(b.degenerate)
    _assert_same_frame(a, b)
    # on CPU tensors every wrapper takes its plain version
    assert set(kernels.launch_counts().values()) == {0}


def test_frame_train_stats_and_cloud_match_jax():
    from leafgrasp_tpu.pipeline.frame import select_grasp as j_select
    from leafgrasp_tpu_torch.pipeline.frame import select_grasp
    mask, depth = _scene("sparse")
    variables, model = _weights()
    rng = np.random.default_rng(4)
    stats = {"depth_mean": np.float32(0.7), "depth_std": np.float32(0.05),
             "score_mean": rng.random(7).astype(np.float32),
             "score_std": rng.random(7).astype(np.float32) + 0.5}
    cfg = jcfg.DEFAULT_CONFIG.replace(fusion=jcfg.MLFusionConfig(
        patch_normalization="train_stats"))
    tc = tcfg.DEFAULT_CONFIG.replace(fusion=tcfg.MLFusionConfig(
        patch_normalization="train_stats"))
    a = j_make_frame_fn(cfg, with_cnn=True, norm_stats=stats)(
        mask, depth, CX, CY, F, variables)
    b = make_frame_fn(tc, with_cnn=True, device="cpu", norm_stats=stats)(
        mask, depth, CX, CY, F, model)
    _assert_same_frame(a, b)
    # the organized-cloud cross-check (points far off the depth ray)
    points = rng.normal(size=(H, W, 3)).astype(np.float32)
    a = j_select(mask, depth, CX, CY, F, points=points)
    b = select_grasp(mask, depth, CX, CY, F, points=points, device="cpu")
    _assert_same_frame(a, b)


def test_make_frame_fn_checks_config():
    bad = tcfg.DEFAULT_CONFIG.replace(
        fusion=tcfg.MLFusionConfig(patch_normalization="zscore"))
    with pytest.raises(ValueError, match="patch_normalization"):
        make_frame_fn(bad, device="cpu")
    ts = tcfg.DEFAULT_CONFIG.replace(
        fusion=tcfg.MLFusionConfig(patch_normalization="train_stats"))
    with pytest.raises(ValueError, match="norm_stats"):
        make_frame_fn(ts, with_cnn=True, device="cpu")


def test_default_device_is_cuda_with_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frame_fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frame_fn(device="cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_host_reads_are_counted():
    mask, depth = _scene("large_leaf")
    fn = make_frame_fn(tcfg.DEFAULT_CONFIG, device="cpu")
    tdevice.reset_host_reads()
    fn(mask, depth, CX, CY, F)
    first = tdevice.host_reads()
    assert first > 0
    fn(mask, depth, CX, CY, F)
    assert tdevice.host_reads() == 2 * first
