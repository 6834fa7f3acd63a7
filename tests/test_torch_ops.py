"""The PyTorch port's ops and geometry modules against the JAX package.

Inputs are made with numpy from a seed and fed to both. EDT fields,
masks, integer maps and leaf ids compare bit-exact; float maps at an
f32 tolerance of 1e-5 absolute (the two frameworks round algebraically
equal expressions in different orders).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from leafgrasp_tpu.io.scenes import make_leaf_scene
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.ops import edt as tedt
from leafgrasp_tpu_torch.ops import morphology as tmorph

# leafgrasp_tpu.ops re-exports functions under the module names
jedt = importlib.import_module("leafgrasp_tpu.ops.edt")
jmorph = importlib.import_module("leafgrasp_tpu.ops.morphology")

CX, CY, F = np.float32(180.0), np.float32(135.0), np.float32(800.0)
F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _exact(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _edt_equal(jax_field, port_field, msg=""):
    """Distance fields: the port's must be the correctly rounded square
    root of the JAX field's (integer) squared distances. XLA:CPU's fused
    f32 sqrt is not correctly rounded (it can be 1 ulp off, e.g.
    sqrt(8354)), while torch.sqrt and the CUDA sqrtf are, so the sqrt
    fields are held to the exact squares, not to XLA's last bit."""
    j = _np(jax_field).astype(np.float64)
    d2 = np.round(j * j)
    np.testing.assert_array_less(np.abs(j * j - d2), 0.5, err_msg=msg)
    _exact(np.sqrt(d2.astype(np.float32)), port_field, msg)
    _close(jax_field, port_field, msg, atol=2e-4)


def _close(a, b, msg="", atol=F32_TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def scene():
    return make_leaf_scene(height=270, width=360, num_leaves=4, seed=3,
                           margin=40)


def _seed_sets(mask):
    """Seed masks covering dense, sparse, seedless and all-seed cases."""
    rng = np.random.default_rng(7)
    h, w = mask.shape
    sparse = np.zeros((h, w), bool)
    sparse[5, w - 9] = True
    return {"fg": mask > 0, "leaf": mask == 3, "bg": mask == 0,
            "noise": rng.random((h, w)) < 0.01, "sparse": sparse,
            "empty": np.zeros((h, w), bool), "full": np.ones((h, w), bool)}


# ---- config / scenes ---------------------------------------------------

def test_config_copy_matches_jax():
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) \
        == dataclasses.asdict(jcfg.DEFAULT_CONFIG)


def test_make_leaf_scene_matches_jax():
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene as t_scene
    for args in ((96, 160, 3, 1, 20), (270, 360, 6, 8, 30)):
        h, w, n, seed, margin = args
        jm, jd = make_leaf_scene(h, w, num_leaves=n, seed=seed, margin=margin)
        tm, td = t_scene(h, w, num_leaves=n, seed=seed, margin=margin)
        _exact(jm, tm)
        _exact(jd, td)


# ---- EDT -----------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_seed_dist_1d_bit_exact(scene, axis):
    seeds = np.stack([s for s in _seed_sets(scene[0]).values()])
    directional = jax.jit(jedt.directional_seed_dist_1d,
                          static_argnames="axis")
    for a, s in ((axis + 1, seeds), (axis, seeds[0])):
        jb, ja = directional(s, axis=a)
        tb, ta = tedt.directional_seed_dist_1d(_t(s), axis=a)
        _exact(jb, tb)
        _exact(ja, ta)
        _exact(np.minimum(jb, ja), tedt.nearest_seed_dist_1d(_t(s), axis=a))


def test_squared_edt_banded_and_full_bit_exact(scene):
    for name, s in _seed_sets(scene[0]).items():
        want = jedt.squared_edt(s)
        _exact(want, tedt.squared_edt(_t(s)), name)
        _exact(want, tedt.squared_edt_full(_t(s)), name)
        _edt_equal(jedt.edt(s), tedt.edt(_t(s)), name)


def test_squared_edt_band_mask_bit_exact(scene):
    """band_mask: exact on the mask (an overestimate elsewhere, in both)."""
    mask = scene[0]
    leaf = mask == 1
    got = tedt.squared_edt(_t(~leaf), band_mask=_t(leaf))
    want = jedt.squared_edt(~leaf, band_mask=leaf)
    _exact(want, got)


def test_squared_edt_keeps_sentinel():
    h, w = 40, 70
    got = tedt.squared_edt(torch.zeros((h, w), dtype=torch.bool))
    assert float(got.min()) == float((h + w) ** 2)


@pytest.mark.parametrize("src_pad", [0, 24])
def test_squared_edt_window_bit_exact(scene, src_pad):
    mask = scene[0]
    seeds = np.stack([mask != 1, mask == 1, mask == 4])
    g = np.asarray(jedt.nearest_seed_dist_1d(seeds, axis=1)) \
        .astype(np.float32)
    g2 = g * g
    for r0, c0, hq, wq in ((10, 20, 64, 96), (200, 250, 70, 110)):
        if src_pad:
            want = jedt.squared_edt_window_src(g2, r0, c0, hq, wq, src_pad)
            got = tedt.squared_edt_window_src(_t(g2), r0, c0, hq, wq,
                                              src_pad)
        else:
            want = jedt.squared_edt_window(g2, r0, c0, hq, wq)
            got = tedt.squared_edt_window(_t(g2), r0, c0, hq, wq)
        _exact(want, got)
        _exact(jedt.squared_edt_window(g2[0], r0, c0, hq, wq),
               tedt.squared_edt_window(_t(g2[0]), r0, c0, hq, wq))


def test_edt_max_argmax_bit_exact(scene):
    for name, s in _seed_sets(scene[0]).items():
        jm, ja = jedt.edt_max_argmax(s)
        tm, ta = tedt.edt_max_argmax(_t(s))
        _edt_equal(jm, tm, name)
        _exact(ja, ta, name)


def test_edt_max_argmax_batch_bit_exact(scene):
    sets = _seed_sets(scene[0])
    seeds = np.stack([sets[k] for k in ("fg", "leaf", "sparse", "empty",
                                        "full")])
    g = np.asarray(jedt.nearest_seed_dist_1d(seeds, axis=1)) \
        .astype(np.float32)
    g2 = g * g
    const = np.array([False, False, False, True, False])
    for cf in (None, const):
        jm, ja = jedt.edt_max_argmax_batch(
            g2, constant_field=None if cf is None else jnp.asarray(cf))
        tm, ta = tedt.edt_max_argmax_batch(
            _t(g2), constant_field=None if cf is None else _t(cf))
        _edt_equal(jm, tm)
        _exact(ja, ta)


def test_edt_max_argmax_coverage_fallback(scene, monkeypatch):
    """With a tiny candidate budget the coverage guard fails and both
    packages take the full sweep; the port must still agree."""
    calls = []
    full = tedt._full_max_argmax

    def spy(g2):
        calls.append(g2.shape)
        return full(g2)

    monkeypatch.setattr(tedt, "_full_max_argmax", spy)
    seeds = np.zeros((96, 160), bool)
    seeds[:, 0] = True
    seeds[:, -1] = True            # a wide plateau of equal maxima
    jm, ja = jedt.edt_max_argmax(seeds, k=64)
    tm, ta = tedt.edt_max_argmax(_t(seeds), k=64)
    _edt_equal(jm, tm)
    _exact(ja, ta)
    assert calls, "the coverage guard should have fallen back"
    g = np.asarray(jedt.nearest_seed_dist_1d(seeds[None], axis=1)) \
        .astype(np.float32)
    jm, ja = jedt.edt_max_argmax_batch(g * g, k=64)
    tm, ta = tedt.edt_max_argmax_batch(_t(g * g), k=64)
    _edt_equal(jm, tm)
    _exact(ja, ta)
    assert len(calls) == 2


# ---- morphology -----------------------------------------------------------

@pytest.mark.parametrize("size", [3, 15, 30, 40])
def test_morphology_bit_exact(scene, size):
    mask = scene[0]
    _exact(jmorph.elliptical_kernel(size), tmorph.elliptical_kernel(size))
    _exact(jmorph.elliptical_kernel(size, size + 3),
           tmorph.elliptical_kernel(size, size + 3))
    k = jmorph.elliptical_kernel(size)
    for m in (mask > 0, mask == 2):
        _exact(jmorph.dilate(m, k), tmorph.dilate(_t(m), k))
        _exact(jmorph.erode(m, k), tmorph.erode(_t(m), k))


@pytest.mark.parametrize("impl", ["levels", "runs"])
def test_dilated_vertical_dist_multi_bit_exact(scene, impl):
    other = (scene[0] > 0) & (scene[0] != 2)
    d_up, d_dn = jedt.directional_seed_dist_1d(other, axis=0)
    kernels = (jmorph.elliptical_kernel(30), jmorph.elliptical_kernel(40),
               np.ones((3, 5), np.uint8))
    want = jmorph.dilated_vertical_dist_multi(d_up, d_dn, kernels,
                                              impl=impl)
    got = tmorph.dilated_vertical_dist_multi(_t(d_up), _t(d_dn), kernels,
                                             impl=impl)
    for a, b in zip(want, got):
        _exact(a, b)
    # and equal to the dilation's own vertical distances wherever a
    # column has a seed (seedless columns keep a sentinel >= H + W - 15)
    h, w = other.shape
    direct = tedt.nearest_seed_dist_1d(
        tmorph.dilate(_t(other), kernels[0]), axis=0)
    seeded = direct < h + w
    _exact(got[0][seeded], direct[seeded])
    assert bool((got[0][~seeded] >= h + w - 15).all())


def test_dilated_vertical_dist_empty_se_falls_back_to_runs(scene):
    other = scene[0] == 2
    d_up, d_dn = tedt.directional_seed_dist_1d(_t(other), axis=0)
    empty = np.zeros((5, 5), np.uint8)
    lv = tmorph.dilated_vertical_dist_multi(d_up, d_dn, (empty,),
                                            impl="levels")
    runs = tmorph.dilated_vertical_dist_multi(d_up, d_dn, (empty,),
                                              impl="runs")
    _exact(lv[0], runs[0])
    assert int(lv[0].min()) == sum(other.shape)   # no seed anywhere


# ---- conv / components / pareto / top-k -----------------------------------

def test_conv_matches_jax(scene):
    jconv = importlib.import_module("leafgrasp_tpu.ops.conv")
    from leafgrasp_tpu_torch.ops import conv as tconv
    depth = scene[1] * (scene[0] == 2)
    _close(jconv.smooth_depth(depth, 5), tconv.smooth_depth(_t(depth), 5))
    for a, b in zip(jconv.sobel_gradients(depth),
                    tconv.sobel_gradients(_t(depth))):
        _close(a, b)
    _close(jconv.flatness_from_depth(depth, 5.0, 5),
           tconv.flatness_from_depth(_t(depth), 5.0, 5))


@pytest.mark.parametrize("max_leaves", [3, 16])
def test_leaf_stats_matches_jax(scene, max_leaves):
    from leafgrasp_tpu.ops.components import leaf_stats as jstats
    from leafgrasp_tpu_torch.ops.components import leaf_stats as tstats
    mask, depth = scene
    a = jstats(mask, depth, max_leaves, CX, CY, F)
    b = tstats(_t(mask), _t(depth), max_leaves, _t(CX), _t(CY), _t(F))
    for name in ("area", "border_contact", "present", "median_depth",
                 "centroid_x", "centroid_y"):
        _exact(getattr(a, name), getattr(b, name), name)
    for name in ("mean_depth", "mean_ray_norm"):
        np.testing.assert_allclose(_np(getattr(a, name)),
                                   _np(getattr(b, name)), rtol=1e-6,
                                   err_msg=name)


def test_masked_median_matches_numpy():
    from leafgrasp_tpu_torch.ops.components import masked_median
    rng = np.random.default_rng(2)
    depth = (rng.random((40, 60)) * 0.5 + 0.3).astype(np.float32)
    ids = rng.integers(0, 5, (40, 60))
    counts = torch.bincount(_t(ids).reshape(-1), minlength=5)
    med = masked_median(_t(depth), _t(ids), counts, 5).numpy()
    span = depth.max() - depth.min()
    for n in range(5):
        assert abs(med[n] - np.median(depth[ids == n])) <= span * 2 ** -17


def test_pareto_mask_matches_jax():
    from leafgrasp_tpu.ops.pareto import pareto_mask as jp
    from leafgrasp_tpu_torch.ops.pareto import pareto_mask as tp
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((16, 3)), 1).astype(np.float32)  # ties
    valid = rng.random(16) < 0.8
    _exact(jp(scores, valid), tp(_t(scores), _t(valid)))


def test_topk_ties_break_by_ascending_index():
    from leafgrasp_tpu.ops.topk import topk_min_distance as jtop
    from leafgrasp_tpu_torch.ops.topk import topk_min_distance as ttop
    rng = np.random.default_rng(5)
    score = np.round(rng.random((60, 80)) * 4).astype(np.float32) / 4
    valid = rng.random((60, 80)) < 0.7
    for k, md in ((20, 3), (30, 10)):
        a = jtop(score, valid, k=k, min_distance=md)
        b = ttop(_t(score), _t(valid), k=k, min_distance=md)
        for name in a._fields:
            _exact(getattr(a, name), getattr(b, name), name)


# ---- orientation -----------------------------------------------------------

def test_orientation_matches_jax(scene):
    jpca = importlib.import_module("leafgrasp_tpu.ops.pca")
    from leafgrasp_tpu_torch.ops import pca as tpca
    mask = scene[0]
    rng = np.random.default_rng(8)
    frag = (mask == 1) | (rng.random(mask.shape) < 0.002)   # extra blobs
    cases = [mask == i for i in range(1, 5)] + [
        frag, np.zeros_like(mask, bool), np.ones_like(mask, bool)]
    for i, m in enumerate(cases):
        for fn in ("min_area_rect", "mask_orientation"):
            a = jax.jit(getattr(jpca, fn))(m)
            b = getattr(tpca, fn)(_t(m))
            _exact(a.valid, b.valid, f"{fn} {i}")
            if bool(a.valid):
                for name in ("angle", "major_axis", "minor_axis", "center"):
                    np.testing.assert_allclose(
                        _np(getattr(a, name)), _np(getattr(b, name)),
                        rtol=1e-5, atol=1e-4, err_msg=f"{fn} {i} {name}")


def test_min_area_rect_matches_jax_on_many_leaves():
    """Every leaf of several seeded scenes (seed 22 holds the near-tied
    rectangle angles of the golden leaf), two components and a holed
    blob: the same rectangle as the JAX package (which matches
    cv2.minAreaRect, tests/test_ops_misc.py)."""
    jpca = importlib.import_module("leafgrasp_tpu.ops.pca")
    from leafgrasp_tpu_torch.ops.pca import min_area_rect
    cases = []
    for seed in (0, 2, 6, 9, 22, 25):
        mask, _ = make_leaf_scene(270, 360, num_leaves=5, seed=seed,
                                  margin=40)
        cases += [mask == lid for lid in np.unique(mask)
                  if lid and (mask == lid).sum() >= 800]
    two = np.zeros((120, 160), bool)
    two[10:30, 10:40] = True
    two[50:110, 60:150] = True
    holed = np.zeros((120, 160), bool)
    holed[20:100, 30:130] = True
    holed[40:80, 60:100] = False
    cases += [two, holed]
    jrect = jax.jit(jpca.min_area_rect)
    for i, m in enumerate(cases):
        a, b = jrect(m), min_area_rect(_t(m))
        assert bool(a.valid) and bool(b.valid), i
        da = (float(a.angle) - float(b.angle) + np.pi / 2) % np.pi \
            - np.pi / 2
        assert abs(da) < 1e-5, (i, float(a.angle), float(b.angle))
        for name in ("major_axis", "minor_axis", "center"):
            np.testing.assert_allclose(_np(getattr(a, name)),
                                       _np(getattr(b, name)), rtol=1e-5,
                                       atol=1e-4, err_msg=f"{i} {name}")


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 11])
def test_leaf_selection_matches_loop_oracle(seed):
    """The port against the repo's loop-based reference selector
    (tests/reference_impl.py), as tests/test_geometry.py holds JAX."""
    from tests import reference_impl as ref
    from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
    mask, depth = make_leaf_scene(height=270, width=360, num_leaves=4,
                                  seed=seed, margin=40)
    area = 1500
    sel = select_optimal_leaf(
        _t(mask), _t(depth), _t(CX), _t(CY), _t(F),
        cfg=tcfg.LeafSelectionConfig(min_leaf_area=area),
        frame=tcfg.FrameConfig(height=270, width=360, max_leaves=8))
    expected, cands = ref.select_leaf_reference(mask, depth, CX, CY, F,
                                                min_area=area, mode="exact")
    if expected is None:
        assert not bool(sel.found)
        return
    assert int(sel.best_leaf_id) == expected
    for lid, c in cands.items():
        np.testing.assert_allclose(sel.scores[lid - 1].numpy(), c["s"],
                                   rtol=2e-4, atol=2e-5)
        assert bool(sel.is_tall[lid - 1]) == c["tall"]


# ---- geometry ----------------------------------------------------------------

def test_select_optimal_leaf_matches_jax(scene):
    from leafgrasp_tpu.geometry.leaf_scorer import select_optimal_leaf as js
    from leafgrasp_tpu_torch.geometry.leaf_scorer import \
        select_optimal_leaf as ts
    mask, depth = scene
    a = js(mask, depth, CX, CY, F)
    b = ts(_t(mask), _t(depth), _t(CX), _t(CY), _t(F))
    for name in ("best_leaf_id", "found", "candidate", "is_tall",
                 "on_front"):
        _exact(getattr(a, name), getattr(b, name), name)
    _close(a.scores, b.scores)
    _close(a.weighted, b.weighted)


@pytest.mark.parametrize("mode", ["union", "reference_self", "skip"])
def test_grasp_scores_match_jax(scene, mode):
    from leafgrasp_tpu.geometry.grasp_scorer import compute_grasp_scores as jg
    from leafgrasp_tpu_torch.geometry.grasp_scorer import \
        compute_grasp_scores as tg
    mask, depth = scene
    skip = mode == "skip"
    iso = "union" if skip else mode
    jc = jcfg.GraspScoringConfig(isolation_context=iso)
    tc = tcfg.GraspScoringConfig(isolation_context=iso)
    for leaf_id in (2, 3, 99):                        # 99: empty leaf
        leaf = mask == leaf_id
        a = jg(leaf, mask > 0, depth, CX, CY, F, cfg=jc,
               skip_isolation=skip)
        b = tg(_t(leaf), _t(mask > 0), _t(depth), _t(CX), _t(CY), _t(F),
               cfg=tc, skip_isolation=skip)
        _edt_equal(a.distance_map, b.distance_map, f"{leaf_id} distance")
        _exact(a.valid_region, b.valid_region, f"{leaf_id} valid")
        _exact(a.stem_penalty, b.stem_penalty, f"{leaf_id} stem")
        for name in a._fields:
            _close(getattr(a, name), getattr(b, name), f"{leaf_id} {name}")


def test_grasp_scores_leaf_window_src_pad(scene):
    """The source-restricted window (leaf_window_src_pad) is exact."""
    from leafgrasp_tpu.geometry.grasp_scorer import compute_grasp_scores as jg
    from leafgrasp_tpu_torch.geometry.grasp_scorer import \
        compute_grasp_scores as tg
    mask, depth = scene
    leaf = mask == 2
    kw = dict(leaf_windows=(64, 128, 256), leaf_window_src_pad=40)
    a = jg(leaf, mask > 0, depth, CX, CY, F,
           cfg=jcfg.GraspScoringConfig(**kw))
    b = tg(_t(leaf), _t(mask > 0), _t(depth), _t(CX), _t(CY), _t(F),
           cfg=tcfg.GraspScoringConfig(**kw))
    for name in a._fields:
        _close(getattr(a, name), getattr(b, name), name)
    _edt_equal(a.distance_map, b.distance_map)


def test_grasp_scores_reject_unported_mode(scene):
    from leafgrasp_tpu_torch.geometry.grasp_scorer import compute_grasp_scores
    mask, depth = scene
    args = (_t(mask == 1), _t(mask > 0), _t(depth), _t(CX), _t(CY), _t(F))
    # every mode of the JAX package is ported: ``union_half`` runs, and
    # only a name that is no mode at all is rejected
    out = compute_grasp_scores(
        *args, cfg=tcfg.GraspScoringConfig(isolation_context="union_half"))
    assert out.valid_region.dtype == torch.bool
    with pytest.raises(ValueError, match="isolation_context"):
        compute_grasp_scores(
            *args, cfg=tcfg.GraspScoringConfig(isolation_context="halves"))


@pytest.mark.parametrize("norm", ["reference_minmax", "train_stats"])
def test_cnn_inputs_match_jax(scene, norm):
    from leafgrasp_tpu.geometry.grasp_scorer import compute_grasp_scores as jg
    from leafgrasp_tpu.geometry.patches import assemble_cnn_inputs as ja
    from leafgrasp_tpu_torch.geometry.grasp_scorer import \
        compute_grasp_scores as tg
    from leafgrasp_tpu_torch.geometry.patches import assemble_cnn_inputs as ta
    mask, depth = scene
    leaf = mask == 2
    a = jg(leaf, mask > 0, depth, CX, CY, F)
    b = tg(_t(leaf), _t(mask > 0), _t(depth), _t(CX), _t(CY), _t(F))
    xs = np.array([5, 100, 200, 355], np.int32)     # edge clamping too
    ys = np.array([3, 120, 150, 268], np.int32)
    stats = None
    if norm == "train_stats":
        rng = np.random.default_rng(3)
        stats = {"depth_mean": np.float32(0.6), "depth_std": np.float32(0.1),
                 "score_mean": rng.random(7).astype(np.float32),
                 "score_std": rng.random(7).astype(np.float32) + 0.5}
    fa = ja(depth, leaf, a, xs, ys, 32, norm_stats=stats)
    fb = ta(_t(depth), _t(leaf), b, _t(xs), _t(ys), 32, norm_stats=stats)
    assert tuple(fb.shape) == (4, 32, 32, 9)
    _close(fa, fb, atol=1e-4)


def test_lift_and_pre_grasp_match_jax(scene):
    jl = importlib.import_module("leafgrasp_tpu.geometry.lift3d")
    from leafgrasp_tpu_torch.geometry import lift3d as tl
    mask, depth = scene
    leaf = mask == 2
    rng = np.random.default_rng(6)
    points = rng.normal(size=mask.shape + (3,)).astype(np.float32)
    for u, v in ((100, 120), (3, 260), (350, 5)):
        uf, vf = np.float32(u), np.float32(v)
        d = depth[v, u]
        a = jl.lift_to_3d(uf, vf, d, CX, CY, F)
        b = tl.lift_to_3d(_t(uf), _t(vf), _t(d), _t(CX), _t(CY), _t(F))
        _close(a, b, atol=1e-6)
        ac = jl.lift_to_3d_with_cloud(uf, vf, d, points, CX, CY, F)
        bc = tl.lift_to_3d_with_cloud(_t(uf), _t(vf), _t(d), _t(points),
                                      _t(CX), _t(CY), _t(F))
        _close(ac, bc, atol=1e-6)
        pa = jl.pre_grasp_point(a, leaf, CX, CY, F)
        pb = tl.pre_grasp_point(b, _t(leaf), _t(CX), _t(CY), _t(F))
        _close(pa.point, pb.point, atol=1e-6)
        _exact(pa.from_search, pb.from_search)


@pytest.mark.parametrize("use_ml", [False, True])
def test_fusion_matches_jax(use_ml):
    from leafgrasp_tpu.pipeline.fusion import fuse_candidates as jf
    from leafgrasp_tpu_torch.pipeline.fusion import fuse_candidates as tf
    rng = np.random.default_rng(9)
    trad = rng.random(20).astype(np.float32)
    ml = rng.random(20).astype(np.float32)
    acc = np.arange(20) < 15
    a = jf(trad, ml, acc, use_ml, jcfg.MLFusionConfig())
    b = tf(_t(trad), _t(ml), _t(acc), use_ml, tcfg.MLFusionConfig())
    _exact(a.best_index, b.best_index)
    _exact(a.ml_used, b.ml_used)
    _close(a.best_score, b.best_score)
    _close(a.combined, b.combined)
