"""Port counterparts of the JAX tests that named a public or helper
function no other port test held against JAX, each on the same numpy
inputs as the JAX test:

* tests/test_aux_components.py:217-258 -> the config IO tests (YAML and
  JSON round trips, partial and unknown keys, the shipped
  ``configs/*.yaml``): the port's configs equal JAX's field by field and
  the files the two packages write are byte-equal;
* :125 ``test_plot_metrics`` -> the same figure, pixel for pixel;
* tests/test_host_shell.py:291 ``ONLINE_TRAIN_CONFIG`` -> equal fields;
* tests/test_training.py:186 (``NormStats`` in a checkpoint) -> the same
  fields, and a port checkpoint's statistics round trip;
* tests/test_geometry.py:199 ``extract_patches`` and :157
  ``project_to_2d`` -> equal patches and pixels;
* tests/test_ops_morphology.py:62 ``morphological_boundary`` and :149
  ``_col_runs`` -> equal masks and runs, the same rejections;
* tests/test_ops_edt.py:261 ``_tile_candidates`` -> the same bound and
  candidates (bit-equal) and the coverage contract;
* tests/test_ops_misc.py:282, :350 ``_largest_component_extremes`` ->
  the same extremes and overflow flag.

Every comparison is exact: these are integer, boolean or gathered
values, and float values computed by the same single operations.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ("baseline.yaml", "enhanced_fast.yaml", "reference_parity.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- config IO (test_aux_components.py:217-258) ----------------------------

@pytest.mark.parametrize("ext", ["yaml", "json"])
def test_config_roundtrip_matches_jax(tmp_path, ext):
    got = tcfg.DEFAULT_CONFIG.replace(
        grasp=tcfg.GraspScoringConfig(isolation_context="reference_self"))
    want = jcfg.DEFAULT_CONFIG.replace(
        grasp=jcfg.GraspScoringConfig(isolation_context="reference_self"))
    p, pj = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    tcfg.save_config(got, p)
    jcfg.save_config(want, pj)
    assert open(p, "rb").read() == open(pj, "rb").read()
    assert tcfg.load_config(p) == got
    assert tcfg.load_config(pj) == got
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_partial_and_unknown_keys_match_jax(tmp_path):
    p = tmp_path / "partial.yaml"
    p.write_text("frame:\n  height: 540\nleaf:\n  min_leaf_area: 42\n")
    cfg = tcfg.load_config(str(p))
    assert cfg.frame.height == 540 and cfg.frame.width == 1440
    assert cfg.leaf.min_leaf_area == 42
    assert cfg == tcfg.DEFAULT_CONFIG.replace(frame=cfg.frame, leaf=cfg.leaf)
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jcfg.load_config(str(p)))
    bad = tmp_path / "bad.yaml"
    bad.write_text("grasp:\n  no_such_knob: 1\n")
    for pkg in (tcfg, jcfg):
        with pytest.raises(ValueError):
            pkg.load_config(str(bad))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_loads_equal_and_writes_the_same_bytes(tmp_path,
                                                               name):
    path = os.path.join(ROOT, "configs", name)
    got, want = tcfg.load_config(path), jcfg.load_config(path)
    hash(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    p, pj = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    tcfg.save_config(got, p)
    jcfg.save_config(want, pj)
    assert open(p, "rb").read() == open(pj, "rb").read()
    assert tcfg.load_config(p) == got


def test_shipped_configs_are_the_three_presets():
    assert sorted(n for n in os.listdir(os.path.join(ROOT, "configs"))
                  if n.endswith(".yaml")) == sorted(SHIPPED)


# ---- training (test_aux_components.py:125, test_host_shell.py:291,
#      test_training.py:186) --------------------------------------------------

def test_plot_metrics_draws_the_jax_figure(tmp_path):
    import matplotlib.image as mpimg
    from leafgrasp_tpu.training.plots import plot_metrics as j_plot
    from leafgrasp_tpu_torch.training.plots import plot_metrics
    history = {
        "train_loss": [1.0, 0.8, 0.6],
        "val_loss": [1.1, 0.9, 0.7],
        "metrics": [dict(positive_accuracy=50, negative_accuracy=60,
                         precision=55, recall=52, f1_score=53)] * 3,
    }
    got = plot_metrics(history, str(tmp_path / "port"))
    want = j_plot(history, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(want))


def test_online_train_preset_matches_jax():
    got, want = tcfg.ONLINE_TRAIN_CONFIG, jcfg.ONLINE_TRAIN_CONFIG
    assert (got.pos_weight, got.batch_size, got.learning_rate) == \
        (1.5, 8, 1e-3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_norm_stats_fields_and_checkpoint_roundtrip(tmp_path):
    from leafgrasp_tpu.training.train import NormStats as JNormStats
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    from leafgrasp_tpu_torch.training import NormStats
    from leafgrasp_tpu_torch.training.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    assert NormStats._fields == JNormStats._fields
    stats = NormStats(torch.tensor(0.5), torch.tensor(0.1), torch.zeros(7),
                      torch.ones(7))
    model = GraspPointCNN(tcfg.ModelConfig(encoder_filters=(8,)))
    path = save_checkpoint(str(tmp_path / "ckpt"), model.state_dict(),
                           norm_stats=stats, metrics={"f1_score": 93.1},
                           epoch=7)
    restored = load_checkpoint(path)
    assert restored["meta"]["metrics"]["f1_score"] == 93.1
    assert int(restored["epoch"]) == 7
    for name in NormStats._fields:
        np.testing.assert_array_equal(restored["norm_stats"][name],
                                      getattr(stats, name).numpy())
    for key, val in model.state_dict().items():
        assert torch.equal(restored["state_dict"][key], val), key


# ---- geometry (test_geometry.py:157, :199) ---------------------------------

def test_extract_patches_replicate_padding_matches_jax(rng):
    from leafgrasp_tpu.geometry.patches import extract_patches as j_extract
    from leafgrasp_tpu_torch.geometry.patches import extract_patches
    maps = rng.random((3, 50, 60)).astype(np.float32)
    xs = np.array([0, 30, 59], np.int32)   # includes border centers
    ys = np.array([0, 25, 49], np.int32)
    out = extract_patches(_t(maps), _t(xs), _t(ys), patch_size=32).numpy()
    assert out.shape == (3, 3, 32, 32)
    np.testing.assert_array_equal(out[1], maps[:, 25 - 16:25 + 16,
                                               30 - 16:30 + 16])
    np.testing.assert_array_equal(out[0][:, 0, 16:], maps[:, 0, 0:16])
    np.testing.assert_array_equal(
        out, np.asarray(j_extract(maps, xs, ys, patch_size=32)))


def test_lift_project_roundtrip_matches_jax(rng):
    from leafgrasp_tpu.geometry.lift3d import project_to_2d as j_project
    from leafgrasp_tpu_torch.geometry.lift3d import lift_to_3d, project_to_2d
    cx, cy, f = (torch.tensor(np.float32(v)) for v in (180.0, 135.0, 800.0))
    p3 = lift_to_3d(torch.tensor(200.0), torch.tensor(100.0),
                    torch.tensor(0.5), cx, cy, f)
    u, v = project_to_2d(p3, cx, cy, f)
    assert (int(u), int(v)) == (200, 100)
    pts = np.stack([rng.uniform(-0.2, 0.2, 16), rng.uniform(-0.2, 0.2, 16),
                    rng.uniform(0.3, 0.8, 16)], axis=1).astype(np.float32)
    got = np.stack([x.numpy() for x in project_to_2d(_t(pts), cx, cy, f)],
                   axis=1)
    want = [[int(x) for x in j_project(jnp.asarray(p), np.float32(180.0),
                                       np.float32(135.0), np.float32(800.0))]
            for p in pts]     # the JAX function takes one point
    assert got.tolist() == want


# ---- morphology (test_ops_morphology.py:62, :149) --------------------------

def test_morphological_boundary_matches_jax(small_scene):
    from leafgrasp_tpu.ops.morphology import \
        morphological_boundary as j_boundary
    from leafgrasp_tpu_torch.ops.morphology import morphological_boundary
    mask, _ = small_scene
    m = mask == 1
    band = morphological_boundary(_t(m)).numpy()
    assert band.sum() > 0
    assert (band & ~m).sum() == 0  # band lies inside the mask
    np.testing.assert_array_equal(band, np.asarray(j_boundary(m)))


def test_col_runs_match_jax():
    from leafgrasp_tpu.ops.morphology import _col_runs as j_col_runs
    from leafgrasp_tpu_torch.ops.morphology import (_col_runs, _se_levels,
                                                    elliptical_kernel,
                                                    rect_kernel)
    # the non-unimodal SE of test_se_levels_non_unimodal_falls_back
    se = np.array([[1, 0, 1], [1, 1, 1], [1, 0, 1]], dtype=np.uint8)
    kernels = [se, rect_kernel(5, 3)] + [elliptical_kernel(*s) for s in
                                         ((3, 3), (7, 11), (30, 30),
                                          (40, 40))]
    for k in kernels:
        assert _col_runs(k) == j_col_runs(k)
    assert _se_levels(_col_runs(se), 1) is None
    gap = np.array([[1], [0], [1]], dtype=np.uint8)     # a split column
    off = np.array([[1], [0], [0]], dtype=np.uint8)     # misses the anchor
    for bad in (gap, off):
        for fn in (_col_runs, j_col_runs):
            with pytest.raises(ValueError):
                fn(bad)


# ---- EDT (test_ops_edt.py:261) ---------------------------------------------

def test_tile_candidates_coverage_bound_matches_jax():
    from leafgrasp_tpu.ops.edt import _tile_candidates as j_tiles
    from leafgrasp_tpu_torch.ops.edt import _tile_candidates
    rng = np.random.default_rng(3)
    ds = (rng.random((120, 41)) * 50).astype(np.float32)
    kth, flat, exhaustive = _tile_candidates(_t(ds), 256)
    assert not exhaustive          # 15x6=90 tiles > 256/64=4
    sel = np.zeros(ds.size, bool)
    sel[flat.numpy()] = True
    assert ds.ravel()[~sel].max() <= float(kth) + 1e-6
    assert sel[ds.ravel() > float(kth)].all()
    jk, jflat, jex = j_tiles(jnp.asarray(ds), 256)
    assert float(kth) == float(jk) and exhaustive == jex
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


# ---- component labeling (test_ops_misc.py:282, :350) -----------------------

def _adversarial_masks():
    """test_largest_component_labeling_adversarial's shapes."""
    rng = np.random.default_rng(3)
    masks = []
    sp = np.zeros((64, 64), bool)
    x0, x1, y0, y1 = 2, 61, 2, 61
    while x1 - x0 > 6:
        sp[y0, x0:x1] = True
        sp[y0:y1, x1 - 1] = True
        sp[y1 - 1, x0:x1] = True
        sp[y0 + 2:y1, x0] = True
        x0 += 4
        x1 -= 4
        y0 += 4
        y1 -= 4
    masks.append(sp)
    comb = np.zeros((50, 80), bool)
    comb[45:48, 4:76] = True
    for t in range(4, 76, 6):
        comb[5:45, t:t + 2] = True
    masks.append(comb)
    dg = np.zeros((48, 48), bool)
    for i in range(40):
        dg[4 + i, 4 + i] = True
    dg[30:40, 4:10] = True
    masks.append(dg)
    masks.append(rng.random((60, 90)) < 0.35)
    masks.append(rng.random((40, 200)) < 0.55)
    edge0 = np.zeros((30, 60), bool)
    edge0[0, 0:51] = True
    edge0[1, 0:11] = True
    edge0[1, 20:31] = True
    edge0[2:11, 20:31] = True
    masks.append(edge0)
    edge1 = edge0.copy()
    edge1[0, :] = False
    edge1[0, 0:5] = True
    masks.append(edge1)
    return masks


@pytest.mark.parametrize("case", range(7))
def test_largest_component_extremes_match_jax_and_scipy(case):
    import scipy.ndimage as ndi
    from leafgrasp_tpu.ops.pca import _largest_component_extremes as j_lce
    from leafgrasp_tpu_torch.ops.pca import _largest_component_extremes
    m = _adversarial_masks()[case]
    xmin, xmax, valid = _largest_component_extremes(_t(m), 64,
                                                    max_runs=4096)
    assert bool(valid)
    jmin, jmax, jvalid = j_lce(jnp.asarray(m), 64, max_runs=4096)
    np.testing.assert_array_equal(xmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(xmax.numpy(), np.asarray(jmax))
    assert bool(jvalid)
    # and the winner is a largest 8-connected component (scipy)
    lab, n = ndi.label(m, structure=np.ones((3, 3)))
    sizes = ndi.sum_labels(m, lab, index=np.arange(1, n + 1))
    cols = np.arange(m.shape[1])
    matched = False
    for cid in [i + 1 for i in range(n) if sizes[i] == sizes.max()]:
        big = lab == cid
        exp_min = np.where(big.any(1), np.where(big, cols, 10 ** 6).min(1),
                           1 << 20)
        exp_max = np.where(big.any(1), np.where(big, cols, -1).max(1), -1)
        matched |= bool(np.array_equal(xmin.numpy(), exp_min)
                        and np.array_equal(xmax.numpy(), exp_max))
    assert matched


def test_largest_component_overflow_flag_matches_jax():
    from leafgrasp_tpu.ops.pca import _largest_component_extremes as j_lce
    from leafgrasp_tpu_torch.ops.pca import _largest_component_extremes
    m = np.zeros((8, 64), bool)
    m[3, ::4] = True       # 16 runs in one row
    for rpr, ok in ((8, False), (16, True)):
        assert bool(_largest_component_extremes(_t(m), rpr)[2]) is ok
        assert bool(j_lce(jnp.asarray(m), rpr)[2]) is ok
