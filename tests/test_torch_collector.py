"""The port's teacher, collector, tip penalty and dataset checker against
the JAX package, on the CPU at 270 x 360.

Tolerances: tip penalty and patch stacks 1e-6 absolute (the patches are
gathers of the same maps: equal in practice; a stack gathered from each
package's own score maps 1e-5, the maps' tolerance); the teacher's score 1e-5
absolute (a blend of f32 score maps whose kernels' plain versions agree
with JAX's to 1e-6); pools, teacher points and counts equal. The
collector's draws (augmentation noise, jitter, the negative picked from
each pool) come from numpy's generator in the port and from JAX's PRNG in
the JAX package, so noisy depth patches and picked negatives are not
compared value by value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leafgrasp_tpu.config import FrameConfig as JFrameConfig
from leafgrasp_tpu.config import LeafSelectionConfig as JLeafConfig
from leafgrasp_tpu.config import PipelineConfig as JPipelineConfig
from leafgrasp_tpu.geometry.grasp_scorer import compute_grasp_scores as \
    j_scores
from leafgrasp_tpu.geometry.grasp_scorer import tip_penalty_map as j_tip
from leafgrasp_tpu.io.scenes import make_hard_leaf_scene, make_leaf_scene
from leafgrasp_tpu.training.data_collector import GraspDataCollector as \
    JCollector
from leafgrasp_tpu.training.teacher import collect_from_frames as j_collect
from leafgrasp_tpu.training.teacher import teacher_select as j_teacher
from leafgrasp_tpu.training.verify_data import verify_dataset as j_verify
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.config import (FrameConfig, LeafSelectionConfig,
                                        PipelineConfig)
from leafgrasp_tpu_torch.geometry.grasp_scorer import (GraspScores,
                                                       compute_grasp_scores,
                                                       tip_penalty_map)
from leafgrasp_tpu_torch.training import (GraspDataCollector,
                                          collect_from_frames,
                                          teacher_select, verify_dataset)

CX, CY, F = 180.0, 135.0, 800.0
POOLS = ("_tip_points", "_stem_points", "_edge_points",
         "_near_boundary_points", "_tip_adjacent_points")


def _scalars():
    return tuple(torch.tensor(np.float32(v)) for v in (CX, CY, F))


def _hard_leaf(seed, rank):
    mask, depth = make_hard_leaf_scene(height=270, width=360,
                                       num_leaves=6, seed=seed, margin=40)
    ids, counts = np.unique(mask[mask > 0], return_counts=True)
    return mask, depth, mask == ids[np.argsort(-counts)][rank]


def _port_scores(jscores) -> GraspScores:
    """The JAX package's score maps as the port's, so that a comparison
    downstream of them sees only the code under test."""
    return GraspScores(*(torch.from_numpy(np.array(v)) for v in jscores))


@pytest.mark.parametrize("seed,rank", [(2, 0), (0, 2)])
def test_tip_penalty_map_matches_jax(seed, rank):
    _, _, leaf = _hard_leaf(seed, rank)
    got = tip_penalty_map(torch.from_numpy(leaf)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_tip(jnp.asarray(leaf))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("seed,rank", [(2, 0), (0, 2)])
def test_negative_pools_equal_jax(tmp_path, seed, rank, pool):
    """Each pool list-equal to JAX's, order included (the tip pools sort
    exact EDT values with many ties through the same ``np.argsort``)."""
    _, _, leaf = _hard_leaf(seed, rank)
    port = GraspDataCollector(str(tmp_path / "port"), resume=False,
                              hard_negatives=True, device="cpu")
    got = dict(zip(POOLS, port.negative_pools(leaf)))[pool]
    want = getattr(JCollector(str(tmp_path / "jax"), resume=False,
                              hard_negatives=True), pool)(leaf)
    assert len(want) > 0
    assert [(int(x), int(y)) for x, y in got] \
        == [(int(x), int(y)) for x, y in want]


@pytest.fixture(scope="module")
def scene_scores():
    mask, depth, leaf = _hard_leaf(2, 0)
    jscores = j_scores(jnp.asarray(leaf), jnp.asarray(mask > 0),
                       jnp.asarray(depth), CX, CY, F)
    return mask, depth, leaf, jscores


def test_patch_stacks_match_jax(tmp_path, scene_scores):
    mask, depth, leaf, jscores = scene_scores
    port = GraspDataCollector(str(tmp_path / "port"), resume=False,
                              device="cpu")
    jcoll = JCollector(str(tmp_path / "jax"), resume=False)
    ys, xs = np.where(leaf)
    for i in (0, len(xs) // 3, len(xs) - 1):
        got = port._patch_stack(torch.from_numpy(leaf),
                                torch.from_numpy(depth),
                                _port_scores(jscores), int(xs[i]), int(ys[i]))
        want = jcoll._patch_stack(leaf, depth, jscores, int(xs[i]),
                                  int(ys[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g, np.float32),
                                       np.asarray(w, np.float32), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("seed,rank", [(2, 0), (3, 1)])
def test_teacher_select_matches_jax(seed, rank):
    mask, depth, leaf = _hard_leaf(seed, rank)
    jpoint, jtotal, _ = j_teacher(jnp.asarray(leaf), jnp.asarray(mask > 0),
                                  jnp.asarray(depth), CX, CY, F)
    point, total, scores = teacher_select(leaf, mask > 0, depth, CX, CY, F,
                                          device="cpu")
    assert jpoint is not None
    assert point == jpoint
    assert abs(total - jtotal) <= 1e-5
    assert isinstance(scores, GraspScores)


@pytest.fixture(scope="module")
def collected_both(tmp_path_factory):
    """JAX's and the port's teacher loop over the same three frames."""
    frames = [make_leaf_scene(270, 360, 4, seed=s, margin=40)
              for s in range(3)]
    kw = dict(frame=dict(height=270, width=360, max_leaves=8),
              leaf=dict(min_leaf_area=1500))
    jcfg = JPipelineConfig(frame=JFrameConfig(**kw["frame"]),
                           leaf=JLeafConfig(**kw["leaf"]))
    cfg = PipelineConfig(frame=FrameConfig(**kw["frame"]),
                         leaf=LeafSelectionConfig(**kw["leaf"]))
    root = tmp_path_factory.mktemp("collect")
    jcoll = JCollector(str(root / "jax"), resume=False)
    port = GraspDataCollector(str(root / "port"), resume=False,
                              device="cpu")
    used = (j_collect(frames, jcoll, CX, CY, F, jcfg),
            collect_from_frames(frames, port, CX, CY, F, cfg))
    return used, jcoll.dataset(), port.dataset(), port


def test_collect_from_frames_matches_jax(collected_both):
    """Same frames used, same teacher points and scores, same positive
    patches, the same number of rotations with the same masks."""
    (jused, used), want, got, _ = collected_both
    assert used == jused == 3
    sel = {}
    for name, ds in (("jax", want), ("port", got)):
        sel[name] = np.where((ds["labels"] == 1) & ~ds["is_augmented"])[0]
    assert len(sel["port"]) == len(sel["jax"]) == 3
    np.testing.assert_array_equal(got["grasp_points"][sel["port"]],
                                  want["grasp_points"][sel["jax"]])
    np.testing.assert_allclose(got["total_scores"][sel["port"]],
                               want["total_scores"][sel["jax"]], rtol=0,
                               atol=1e-5)
    # depth and mask patches are gathers of the same frame; the score
    # patches are gathers of each package's own score maps, which agree
    # to 1e-5 (the port's frame tests hold them there: 2.4e-6 read here)
    for key, tol in (("depth_patches", 1e-6), ("mask_patches", 1e-6),
                     ("score_patches", 1e-5)):
        np.testing.assert_allclose(got[key][sel["port"]],
                                   want[key][sel["jax"]], rtol=0, atol=tol)
    aug = {name: np.where(ds["is_augmented"])[0]
           for name, ds in (("jax", want), ("port", got))}
    assert len(aug["port"]) == len(aug["jax"]) == 9
    np.testing.assert_array_equal(got["mask_patches"][aug["port"]],
                                  want["mask_patches"][aug["jax"]])
    np.testing.assert_array_equal(got["grasp_points"][aug["port"]],
                                  want["grasp_points"][aug["jax"]])


def test_collector_counts_labels_rotation_and_resume(collected_both):
    """Mirrors tests/test_training.py:37-60 on the port's collection."""
    _, _, ds, port = collected_both
    assert port.stats["positive_samples"] == 3
    assert port.stats["augmented_samples"] == 9
    assert port.stats["negative_samples"] >= 3
    assert (ds["labels"] == 1).sum() == 12
    assert ds["depth_patches"].shape[1:] == (32, 32)
    assert ds["score_patches"].shape[1] == 7
    pos = np.where((ds["labels"] == 1) & ~ds["is_augmented"])[0][0]
    for k, a in zip((1, 2, 3), np.where(ds["is_augmented"])[0][:3]):
        np.testing.assert_array_equal(ds["mask_patches"][a],
                                      np.rot90(ds["mask_patches"][pos], k))
        assert abs(ds["total_scores"][a] / ds["total_scores"][pos]
                   - 0.975) <= 0.025 + 1e-6
    reloaded = GraspDataCollector(port.data_dir, resume=True, device="cpu")
    assert len(reloaded.samples) == len(port.samples)
    assert reloaded.stats == port.stats
    for key, val in reloaded.dataset().items():
        np.testing.assert_array_equal(val, ds[key])
    assert verify_dataset(ds)["ok"]


def test_collector_rejects_border_points_and_grows_hard_pools(
        tmp_path, scene_scores):
    mask, depth, leaf, jscores = scene_scores
    scores = compute_grasp_scores(torch.from_numpy(leaf),
                                  torch.from_numpy(mask > 0),
                                  torch.from_numpy(depth), *_scalars())
    base = GraspDataCollector(str(tmp_path / "base"), resume=False,
                              device="cpu")
    assert not base.collect_sample(leaf, depth, scores, (3, 3), 0.5)
    assert base.samples == []
    hard = GraspDataCollector(str(tmp_path / "hard"), resume=False,
                              hard_negatives=True, device="cpu")
    din = np.asarray(jscores.distance_map)
    ys, xs = np.where(leaf & (din > 0))
    pt = (int(xs[len(xs) // 2]), int(ys[len(ys) // 2]))
    assert hard.collect_sample(leaf, depth, scores, pt, 0.8)
    assert base.collect_sample(leaf, depth, scores, pt, 0.8)
    assert hard.stats["negative_samples"] > base.stats["negative_samples"]


def test_verify_dataset_on_the_stored_corpus_matches_jax():
    path = "artifacts/grasp_cnn_hard/training_data/training_data.npz"
    data = dict(np.load(path))
    report = verify_dataset(data)
    assert report == j_verify(data)
    assert report["ok"] and report["num_samples"] == 1230
