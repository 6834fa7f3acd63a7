"""The port's frame A/B and stage tools (tools/micro_bench_*_torch.py)
against the JAX package, on the CPU at 96 x 160.

* frame_ab: both knob variants give every frame the same pixel, and each
  variant's pixels equal JAX ``make_frame_fn``'s with the same knobs and
  the same CNN weights (JAX's ``init_grasp_cnn(PRNGKey(0))``, converted).
* edt_ab: the port's two pass-2 routes, JAX's ``edt_batch`` and JAX's
  ``edt_batch_rowband`` (its Pallas kernel in interpret mode, as
  tests/test_pallas.py runs it) give bit-equal distances; the pass-1
  scans and the row-banded kernel alone bit-equal JAX's.
* batch: B = 2 and 4 on a one-rank gloo mesh equal the single frames, and
  the tool tears its process group down.
* stages: each stage's output equals the JAX stage's on the same inputs:
  leaf stats (integers and medians equal, means 1e-6 relative, as
  tests/test_torch_ops.py), minAreaRect (1e-5 relative, 1e-4 absolute,
  as there), the interference pass 1, the envelope maxima and argmaxes,
  the window pass 2 and the EDTs bit for bit, and the full frame's leaf,
  pixel and flags.

The scenes: the bench families' margins scaled to 96 rows; the stage
tool's ``crowded`` slot takes a scene that holds the envelope's leaf 5
at this size (the production scene's 12 leaves overwrite each other at
96 x 160, leaving 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_tools_bench import CAMERA, FAMILIES, H, W, _small, \
    _weights

import bench_torch
from tools import (micro_bench_batch_torch, micro_bench_edt_ab_torch,
                   micro_bench_frame_ab_torch, micro_bench_stages_torch)

CPU = torch.device("cpu")
SCENES = {"crowded": (8, 10, 5), "sparse": (6, 8, 120 * H // 1080)}
FRAME_AB_VARIANTS = ["reference_self:old", "reference_self:new",
                     "union:old", "union:new"]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _bits_equal(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                  else a,
                                  b.view(np.int32) if b.dtype == np.float32
                                  else b, err_msg=what)


def _jax_frame(cfg, mask, depth, variables, camera=CAMERA):
    from leafgrasp_tpu.pipeline.frame import make_frame_fn
    res = make_frame_fn(cfg, with_cnn=True)(
        np.asarray(mask), np.asarray(depth),
        *[np.float32(v) for v in camera], variables)
    return (int(res.leaf_id), [int(v) for v in np.asarray(res.grasp_uv)],
            bool(res.found), bool(res.degenerate))


# ---- frame_ab ---------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_ab():
    _, model = _weights()
    frames = bench_torch.stage_frames(_small(tcfg), 1, CPU, FAMILIES)
    best, counts, uv = micro_bench_frame_ab_torch.measure(
        _small(tcfg), frames, model, CPU, 1, CAMERA)
    return frames, best, counts, uv


@pytest.mark.parametrize("variant", FRAME_AB_VARIANTS)
def test_frame_ab_pixels_equal_jax_with_the_same_knobs(frame_ab, variant):
    import dataclasses
    frames, best, counts, uv = frame_ab
    assert best[variant] > 0 and counts[variant][1] > 0
    mode, knobs = variant.split(":")
    kw = micro_bench_frame_ab_torch.OLD_KNOBS if knobs == "old" else {}
    base = _small(jcfg)
    cfg = base.replace(grasp=dataclasses.replace(
        base.grasp, isolation_context=mode, **kw))
    variables, _ = _weights()
    for (_, mask, depth), got in zip(frames, uv[variant]):
        assert got == _jax_frame(cfg, mask, depth, variables)[1]
    other = f"{mode}:{'new' if knobs == 'old' else 'old'}"
    assert uv[variant] == uv[other]


def test_frame_ab_raises_when_the_variants_part(monkeypatch):
    """A knob that changed the answer would fail the tool: here the old
    variant's frames are another scene."""
    _, model = _weights()
    frames = bench_torch.stage_frames(_small(tcfg), 1, CPU, FAMILIES[:2])
    real = micro_bench_frame_ab_torch.variant_configs

    def swapped(base):
        cfgs = real(base)
        cfgs["union:old"] = cfgs["union:old"].replace(
            leaf=tcfg.LeafSelectionConfig(min_leaf_area=10 ** 9))
        return cfgs
    monkeypatch.setattr(micro_bench_frame_ab_torch, "variant_configs",
                        swapped)
    with pytest.raises(RuntimeError, match="union frame 0"):
        micro_bench_frame_ab_torch.measure(_small(tcfg), frames, model, CPU,
                                           1, CAMERA)


# ---- edt_ab -----------------------------------------------------------------

@pytest.fixture(scope="module")
def edt_ab():
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    mask, _ = make_leaf_scene(H, W, num_leaves=6, seed=8,
                              margin=SCENES["sparse"][2])
    seeds = micro_bench_edt_ab_torch.seed_channels(mask, CPU)
    results, calls, outs = micro_bench_edt_ab_torch.measure(seeds, CPU, 1, 1)
    return seeds.numpy(), results, calls, outs


def test_edt_routes_bit_equal_jax_edt_batch_and_rowband(edt_ab):
    from leafgrasp_tpu.ops.edt import edt_batch
    from leafgrasp_tpu.ops.pallas_edt import edt_batch_rowband
    seeds, results, _, outs = edt_ab
    assert set(results) == set(outs) and len(outs) == 5
    want = np.asarray(edt_batch(jnp.asarray(seeds)))
    _bits_equal(outs["banded_x3"], want, "banded")
    _bits_equal(outs["rowband_x3"], want, "rowband")
    _bits_equal(np.asarray(edt_batch_rowband(jnp.asarray(seeds),
                                             interpret=True)), want,
                "JAX rowband")


def test_edt_pass1_and_rowband_kernel_bit_equal_jax(edt_ab):
    from leafgrasp_tpu.ops.edt import nearest_seed_dist_1d
    from leafgrasp_tpu.ops.pallas_edt import squared_edt_rowband
    seeds, _, _, outs = edt_ab
    s = jnp.asarray(seeds)
    g = nearest_seed_dist_1d(jnp.swapaxes(s, 1, 2), axis=1)
    g2t = jnp.swapaxes(g, 1, 2).astype(jnp.float32) ** 2
    gv = nearest_seed_dist_1d(s, axis=1).astype(jnp.float32)
    _bits_equal(outs["pass1_transposed_scan"], g2t, "transposed")
    _bits_equal(outs["pass1_vertical_scan"], gv * gv, "vertical")
    _bits_equal(outs["rowband_kernel_only(prepass+kernel)"],
                squared_edt_rowband(g2t, interpret=True), "kernel")


# ---- batch ------------------------------------------------------------------

def test_batched_frames_equal_single_frames_on_a_one_rank_gloo_mesh():
    import torch.distributed as dist
    _, model = _weights()
    cfg = micro_bench_batch_torch.batch_config(_small(tcfg))
    # the crowded family (scaled): its pixel moves as the frames roll
    _, n, seed, margin = FAMILIES[1]
    masks, depths = micro_bench_batch_torch.stage(
        cfg, 4, CPU, dict(num_leaves=n, seed=seed, margin=margin))
    best, counts, uv = micro_bench_batch_torch.measure(
        cfg, masks, depths, model, CPU, batches=(2, 4), trials=1,
        camera=CAMERA)
    assert not dist.is_initialized()
    assert set(best) == {"single", "batch2", "batch4"}
    assert all(v > 0 for v in best.values())
    assert uv["batch4"] == uv["single"] and uv["batch2"] == uv["single"][:2]
    # the frames differ (rolled by 3 px), so equal pixels are no accident
    assert len({tuple(p) for p in uv["single"]}) > 1
    assert all(counts[k][1] > 0 for k in best)


# ---- stages -----------------------------------------------------------------

@pytest.fixture(scope="module")
def stages():
    _, model = _weights()
    cfg = _small(tcfg)
    recs, outs, inputs = micro_bench_stages_torch.measure(
        cfg, model, CPU, n=1, reps=1, profile=False, scenes=SCENES,
        camera=CAMERA)
    crowded = micro_bench_stages_torch.scene(cfg, "crowded", CPU, SCENES)
    sparse = micro_bench_stages_torch.scene(cfg, "sparse", CPU, SCENES)
    return recs, outs, inputs, crowded, sparse


def test_stage_tool_covers_the_jax_tools_stages(stages):
    recs, outs, _, _, _ = stages
    want = {"stages": 13, "iso": 8, "iso2": 5, "envelope": 15}
    for group, n in want.items():
        assert sum(k.startswith(group + "/") for k in recs) == n, group
    for rec in recs.values():
        assert rec["ms"] > 0 and rec["alone_ms"] > 0 and rec["host_ms"] > 0
        assert rec["busy_ms"] is None and rec["launches"] == {}
    assert recs["stages/frame_union"]["host_reads"] > 0
    assert set(recs) == set(outs)


def test_stage_leaf_stats_and_min_area_rect_match_jax(stages):
    from leafgrasp_tpu.ops.components import leaf_stats
    from leafgrasp_tpu.ops.pca import min_area_rect
    _, outs, inputs, (md, dd), _ = stages
    cam = [np.float32(v) for v in CAMERA]
    cases = ((outs["stages/leaf_stats"], 16, cam),
             (outs["envelope/E_leaf_stats_bisection"], 8,
              [np.float32(v) for v in
               micro_bench_stages_torch.ENVELOPE_CAMERA]))
    for got, max_leaves, c in cases:
        want = leaf_stats(md.numpy(), dd.numpy(), max_leaves, *c)
        for name in ("area", "border_contact", "present", "median_depth",
                     "centroid_x", "centroid_y"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        for name in ("mean_depth", "mean_ray_norm"):
            np.testing.assert_allclose(_np(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6)
    a = min_area_rect(jnp.asarray(inputs["stages"]["leaf"].numpy()))
    b = outs["stages/min_area_rect"]
    assert bool(a.valid) and bool(b.valid)
    for name in ("angle", "major_axis", "minor_axis", "center"):
        np.testing.assert_allclose(_np(getattr(b, name)),
                                   np.asarray(getattr(a, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_stage_interference_pass1_and_window_bit_equal_jax(stages):
    from leafgrasp_tpu.ops.edt import (directional_seed_dist_1d,
                                       nearest_seed_dist_1d,
                                       squared_edt_window)
    from leafgrasp_tpu.ops.morphology import (dilated_vertical_dist,
                                              elliptical_kernel)
    _, outs, inputs, _, _ = stages
    ld = jnp.asarray(inputs["stages"]["leaf"].numpy())
    od = jnp.asarray(inputs["stages"]["other"].numpy())
    du, dn = directional_seed_dist_1d(od, axis=0)
    for got, k in zip(outs["stages/dvd_close_wide"], (30, 40)):
        _bits_equal(got, dilated_vertical_dist(du, dn, elliptical_kernel(k)))
    _bits_equal(outs["stages/pass1_2ch"],
                nearest_seed_dist_1d(jnp.stack([~ld, ld]), axis=1))
    g = nearest_seed_dist_1d(jnp.stack([~ld, ld]), axis=1) \
        .astype(jnp.float32)
    win = min(micro_bench_stages_torch.WINDOW, H, W)
    rows, cols = np.asarray(ld).any(1), np.asarray(ld).any(0)
    r0 = int(np.clip(np.argmax(rows), 0, H - win))
    c0 = int(np.clip(np.argmax(cols), 0, W - win))
    _bits_equal(outs["stages/window_pass2"],
                squared_edt_window(g * g, r0, c0, win, win))


def test_stage_envelope_maxima_and_argmaxes_bit_equal_jax(stages):
    from leafgrasp_tpu.ops.edt import (directional_seed_dist_1d,
                                       edt_max_argmax_batch,
                                       nearest_seed_dist_1d)
    from leafgrasp_tpu.ops.morphology import (dilated_vertical_dist,
                                              elliptical_kernel)
    _, outs, inputs, (md, _), _ = stages
    ld = jnp.asarray(inputs["stages"]["leaf"].numpy())
    od = jnp.asarray(inputs["stages"]["other"].numpy())
    du, dn = directional_seed_dist_1d(od, axis=0)
    gc, gw = (dilated_vertical_dist(du, dn, elliptical_kernel(k))
              .astype(jnp.float32) for k in (30, 40))
    g = nearest_seed_dist_1d(ld, axis=1).astype(jnp.float32)
    mx, am = edt_max_argmax_batch(jnp.stack([g * g, gc * gc, gw * gw]))
    _bits_equal(outs["stages/envelope_maxes_3"][0], mx)
    _bits_equal(outs["stages/envelope_maxes_3"][1], am)
    # the envelope tool's fields and its D settings
    g2 = _envelope_g2_jax(jnp.asarray(md.numpy()))
    _bits_equal(inputs["envelope"]["g2"], g2, "build_g2")
    cf = jnp.array([False, False, False])
    for stride, k in micro_bench_stages_torch.ENVELOPE_SETTINGS:
        mx, am = edt_max_argmax_batch(g2, stride=stride, k=k,
                                      constant_field=cf)
        got = outs[f"envelope/D_batch_stride{stride}_k{k}"]
        _bits_equal(got[0], mx, f"{stride}/{k} max")
        _bits_equal(got[1], am, f"{stride}/{k} argmax")


def _envelope_g2_jax(mask):
    """micro_bench_envelope.py's ``build_g2`` on ``mask``."""
    from leafgrasp_tpu.ops.edt import directional_seed_dist_1d
    from leafgrasp_tpu.ops.morphology import (dilated_vertical_dist_multi,
                                              elliptical_kernel)
    m = mask == micro_bench_stages_torch.ENVELOPE_LEAF
    other = (mask > 0) & ~m
    d3u, d3d = directional_seed_dist_1d(jnp.stack([~m, m, other]), axis=1)
    g = jnp.minimum(d3u[:2], d3d[:2]).astype(jnp.float32)
    gc, gw = (x.astype(jnp.float32) for x in dilated_vertical_dist_multi(
        d3u[2], d3d[2], (elliptical_kernel(30), elliptical_kernel(40))))
    return jnp.stack([g[1] * g[1], gc * gc, gw * gw])


def test_stage_iso_edts_bit_equal_jax(stages):
    from leafgrasp_tpu.ops.edt import edt_batch, edt_max_argmax, squared_edt
    from leafgrasp_tpu.ops.morphology import dilate, elliptical_kernel
    _, outs, inputs, _, _ = stages
    m = jnp.asarray(inputs["iso"]["leaf"].numpy())
    o = jnp.asarray(inputs["iso"]["other"].numpy())
    sc, sw = dilate(o, elliptical_kernel(30)), dilate(o, elliptical_kernel(40))
    _bits_equal(outs["iso/dilates_only"][0], sc)
    _bits_equal(outs["iso/edt4_enhanced"],
                edt_batch(jnp.stack([~m, m, sc, sw])))
    _bits_equal(outs["iso2/din_banded"], squared_edt(~m))
    mx, am = edt_max_argmax(m)
    _bits_equal(outs["iso2/maxdout"][0], mx)
    _bits_equal(outs["iso2/maxdout"][1], am)


@pytest.mark.parametrize("stage", ["stages/frame_reference_self",
                                   "stages/frame_union",
                                   "stages/frame_union_from_host",
                                   "iso/frame_reference_self",
                                   "iso/frame_union"])
def test_stage_full_frames_equal_jax(stages, stage):
    import dataclasses
    _, outs, _, crowded, sparse = stages
    md, dd = crowded if stage.startswith("stages/") else sparse
    mode = stage.split("frame_")[1].replace("_from_host", "")
    base = _small(jcfg)
    cfg = base.replace(grasp=dataclasses.replace(base.grasp,
                                                 isolation_context=mode))
    res = outs[stage]
    got = (int(res.leaf_id), [int(v) for v in res.grasp_uv],
           bool(res.found), bool(res.degenerate))
    assert got == _jax_frame(cfg, md, dd, _weights()[0])
    assert got[2]
