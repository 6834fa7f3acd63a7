"""The port's row-sharded frame (parallel/spatial_frame.py) and the
service over it against the JAX package's single-frame path, as
tests/test_parallel.py:96-301 and tests/test_host_shell.py:336 hold the
JAX sharded frame.

Four spawned gloo CPU ranks run every case in one spawn (a module
fixture); the JAX side runs in this process, unsharded. Scenes are the
JAX tests' (264 x 360, and one case at 540 x 720); the CNN is the same
Flax initialisation, converted. Tolerances, JAX's own: leaf, grasp
pixel, candidate pixels and flags equal; scores and fused scores 1e-4
relative / 1e-5 absolute; 3D points 1e-6 absolute; the fused scoring
kernel's route against the unfused maps 2e-4 / 2e-5.
"""

import numpy as np
import pytest
import torch

from tests._torch_dist import spawn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

RANKS = 4
CAM = (np.float32(180.0), np.float32(135.0), np.float32(430.0))
# name -> (scene, isolation, with_cnn); scenes by (h, w, leaves, seed)
CASES = {
    "cv_union": ((264, 360, 4, 3), "union", False),
    "cnn_union": ((264, 360, 4, 7), "union", True),
    "cnn_reference_self": ((264, 360, 4, 7), "reference_self", True),
    "cv_union_half": ((264, 360, 4, 3), "union_half", False),
    "fragmented": ("fragmented", "reference_self", False),
    "cnn_union_540x720": ((540, 720, 6, 8), "union", True),
}
UNFUSED = "cnn_reference_self"


def _cfg(pkg, iso, h=264, w=360, min_area=500):
    return pkg.PipelineConfig(
        frame=pkg.FrameConfig(height=h, width=w, max_leaves=8),
        leaf=pkg.LeafSelectionConfig(min_leaf_area=min_area),
        grasp=pkg.GraspScoringConfig(isolation_context=iso))


def _fragmented():
    """A selected leaf cut in two by a stripe, both parts crossing shard
    rows (tests/test_parallel.py's fixture)."""
    h, w = 264, 360
    mask = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((xx - 150.0) / 90) ** 2 + ((yy - 80.0) / 55) ** 2 <= 1
    mask[blob & ~((xx >= 108) & (xx <= 118))] = 1
    mask[((xx - 270.0) / 40) ** 2 + ((yy - 200.0) / 30) ** 2 <= 1] = 2
    depth = np.full((h, w), 0.5, np.float32)
    depth += 0.05 * (yy / h).astype(np.float32)
    return mask, depth


def _scene(spec):
    if spec == "fragmented":
        return _fragmented()
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    h, w, n, seed = spec
    return make_leaf_scene(h, w, num_leaves=n, seed=seed,
                           margin=120 if h > 264 else 40)


def _case_cfg(pkg, name):
    spec, iso, _ = CASES[name]
    h, w = (264, 360) if spec == "fragmented" else spec[:2]
    return _cfg(pkg, iso, h, w, 10000 if h > 264 else 500)


def _cnn(state):
    from leafgrasp_tpu_torch.config import ModelConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    model = GraspPointCNN(ModelConfig()).eval()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def _rejection(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__
    return None


def _frame_ranks(rank, world, cnn_state):
    import leafgrasp_tpu_torch.config as tcfg
    from leafgrasp_tpu_torch.parallel import make_mesh, make_sharded_frame_fn
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    mesh = make_mesh(device="cpu")
    cnn = _cnn(cnn_state)
    out = {"frames": {}, "calls": {}}
    for name, (spec, _, with_cnn) in CASES.items():
        mask, depth = _scene(spec)
        cfg = _case_cfg(tcfg, name)
        extra = (cnn,) if with_cnn else ()
        fn = make_sharded_frame_fn(mesh, cfg, with_cnn=with_cnn)
        out["frames"][name] = fetch_to_host(fn(mask, depth, *CAM, *extra))
        out["calls"][name] = (fn.axis.calls, fn.axis.bytes)
        if name == UNFUSED:
            unfused = make_sharded_frame_fn(mesh, cfg, with_cnn=True,
                                            fused=False)
            out["unfused"] = fetch_to_host(unfused(mask, depth, *CAM, cnn))

    bad_height = tcfg.PipelineConfig(frame=tcfg.FrameConfig(height=270,
                                                            width=360))
    few_rows = tcfg.PipelineConfig(frame=tcfg.FrameConfig(height=64,
                                                          width=360))
    train_stats = tcfg.DEFAULT_CONFIG.replace(
        fusion=tcfg.MLFusionConfig(patch_normalization="train_stats"))
    out["rejections"] = {
        "height_not_dividing": _rejection(
            lambda: make_sharded_frame_fn(mesh, bad_height)),
        "too_few_rows": _rejection(
            lambda: make_sharded_frame_fn(mesh, few_rows)),
        "union_half_cnn": _rejection(lambda: make_sharded_frame_fn(
            mesh, _cfg(tcfg, "union_half"), with_cnn=True)),
        "train_stats_cnn": _rejection(lambda: make_sharded_frame_fn(
            mesh, train_stats, with_cnn=True)),
        "service_train_stats": _rejection(lambda: GraspService(
            train_stats, cnn=cnn, spatial_mesh=mesh, device="cpu")),
    }

    msgs, results = [], []
    svc = GraspService(_cfg(tcfg, "union"), min_interval_s=0.0,
                       spatial_mesh=mesh, device="cpu",
                       publish=msgs.append, on_result=results.append)
    mask, depth = _scene((264, 360, 4, 3))
    svc.on_mask(mask)
    svc.on_depth(depth)
    got = svc.process_pending(force=True)
    out["service"] = {"message": got["message"], "published": msgs,
                      "on_result": len(results)}
    return out


@pytest.fixture(scope="module")
def cnn_variables():
    import jax
    from leafgrasp_tpu.config import ModelConfig
    from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
    _, variables = init_grasp_cnn(jax.random.PRNGKey(0), ModelConfig())
    return variables


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cnn_variables):
    import jax
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    state = flax_to_torch_grasp_cnn(jax.tree.map(np.asarray, cnn_variables))
    return spawn(_frame_ranks, RANKS, tmp_path_factory.mktemp("frame"),
                 {k: v.numpy() for k, v in state.items()})


def _jax_frame(name, cnn_variables):
    import leafgrasp_tpu.config as jcfg
    from leafgrasp_tpu.pipeline.frame import make_frame_fn
    spec, _, with_cnn = CASES[name]
    mask, depth = _scene(spec)
    fn = make_frame_fn(_case_cfg(jcfg, name), with_cnn=with_cnn,
                       use_pallas=False)
    extra = (cnn_variables,) if with_cnn else ()
    return fn(mask, depth, *CAM, *extra)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_frame_matches_jax(ranks, cnn_variables, name):
    want = _jax_frame(name, cnn_variables)
    got = ranks[0]["frames"][name]
    assert bool(got.found)
    assert int(got.leaf_id) == int(want.leaf_id)
    np.testing.assert_array_equal(got.grasp_uv, np.asarray(want.grasp_uv))
    for field in ("x", "y", "accepted"):
        np.testing.assert_array_equal(
            getattr(got.candidates, field),
            np.asarray(getattr(want.candidates, field)), err_msg=field)
    np.testing.assert_allclose(got.candidates.score,
                               np.asarray(want.candidates.score),
                               rtol=1e-4, atol=1e-5)
    for field in ("found", "degenerate", "ml_used"):
        assert bool(getattr(got, field)) == bool(getattr(want, field))
    np.testing.assert_allclose(got.fusion.combined,
                               np.asarray(want.fusion.combined),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.grasp_xyz, np.asarray(want.grasp_xyz),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.pre_grasp_xyz,
                               np.asarray(want.pre_grasp_xyz),
                               rtol=0, atol=1e-6)


def test_every_rank_returns_the_same_frame(ranks):
    for out in ranks[1:]:
        for name in CASES:
            a, b = ranks[0]["frames"][name], out["frames"][name]
            np.testing.assert_array_equal(a.grasp_uv, b.grasp_uv)
            np.testing.assert_array_equal(a.fusion.combined,
                                          b.fusion.combined)
            np.testing.assert_array_equal(a.pre_grasp_xyz, b.pre_grasp_xyz)
        assert out["calls"] == ranks[0]["calls"]


def test_collectives_per_frame(ranks):
    """The CV-only frame: 1 extremes + 1 sums + 18 bisection rounds + the
    fg pass 1 + its argmax + the leaf pass 1 + the orientation runs + the
    stem halo + the gradient halo + the maxima + 20 top-k rounds + the
    candidate depths + the pre-grasp windows; the CNN adds the interference
    halo of ``union`` (its patches ride with the depths)."""
    calls = ranks[0]["calls"]
    assert calls["cv_union"][0] == 49
    assert calls["cnn_reference_self"][0] == 49
    assert calls["cnn_union"][0] == 50
    assert calls["cnn_union"][1] > calls["cv_union"][1]


def test_fused_scoring_matches_unfused_maps(ranks):
    a, b = ranks[0]["frames"][UNFUSED], ranks[0]["unfused"]
    assert int(a.leaf_id) == int(b.leaf_id)
    np.testing.assert_array_equal(a.grasp_uv, b.grasp_uv)
    np.testing.assert_allclose(a.fusion.combined, b.fusion.combined,
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case,error", [
    ("height_not_dividing", "ValueError"), ("too_few_rows", "ValueError"),
    ("union_half_cnn", "NotImplementedError"),
    ("train_stats_cnn", "NotImplementedError"),
    ("service_train_stats", "ValueError")])
def test_sharded_frame_rejections(ranks, case, error):
    for out in ranks:
        assert out["rejections"][case] == error


def test_sharded_service_publishes_the_jax_message(ranks):
    import leafgrasp_tpu.config as jcfg
    from leafgrasp_tpu.pipeline.ingest import GraspService
    svc = GraspService(_cfg(jcfg, "union"), min_interval_s=0.0)
    mask, depth = _scene((264, 360, 4, 3))
    svc.on_mask(mask)
    svc.on_depth(depth)
    want = svc.process_pending(force=True)
    assert want["found"]
    assert ranks[0]["service"] == {"message": want["message"],
                                   "published": [want["message"]],
                                   "on_result": 1}
    for out in ranks[1:]:
        assert out["service"] == {"message": want["message"],
                                  "published": [], "on_result": 0}
