"""The port's grasp service and host-side modules against the JAX
package's: both ``GraspService``s on the same stream of seeded scenes at
270 x 360 (CV-only and with the same CNN weights, converted), the rate
gate, ``pipeline_depth`` and ``flush``, the rerank / reselect flow with a
stub selector, ``stop()`` racing ``run()``, record and replay with logs
crossing the two packages, both frame buses, and the helper modules
(sdf_helper, simple_scorer, predictor, visualizer, replay, tools,
scenes, profiler, device).

Tolerances: leaf id, grasp pixel and flags equal; message floats 1e-4;
helper fields as stated at each test.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from leafgrasp_tpu.io.scenes import make_leaf_scene
from leafgrasp_tpu.pipeline.ingest import GraspService as JGraspService
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch import kernels
from leafgrasp_tpu_torch.io import framebus as tframebus
from leafgrasp_tpu_torch.io import framelog as tframelog
from leafgrasp_tpu_torch.io._native import BUILD_DIR, NATIVE_DIR
from leafgrasp_tpu_torch.pipeline.ingest import (GraspService,
                                                 compact_instance_ids,
                                                 format_result_message,
                                                 leaf_candidates)
from leafgrasp_tpu_torch.utils import device as tdevice

H, W = 270, 360


def _cfg(mod, **grasp):
    return mod.PipelineConfig(
        frame=mod.FrameConfig(height=H, width=W, max_leaves=8),
        leaf=mod.LeafSelectionConfig(min_leaf_area=1500),
        grasp=mod.GraspScoringConfig(**grasp))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream(n=3):
    """Seeded scenes: one family rolled, plus a second and a hard one."""
    mask, depth = make_leaf_scene(height=H, width=W, num_leaves=4, seed=3,
                                  margin=40)
    frames = [(np.roll(mask, 5 * i, axis=1), np.roll(depth, 5 * i, axis=1))
              for i in range(n)]
    frames.append(make_leaf_scene(height=H, width=W, num_leaves=5, seed=11,
                                  margin=40))
    return frames


def _service(**kw):
    kw.setdefault("min_interval_s", 0.0)
    return GraspService(kw.pop("cfg", TCFG), device="cpu", **kw)


def _assert_same_out(a, b):
    """A JAX service result dict against the port's."""
    ra, rb = a["result"], b["result"]
    assert a["found"] == b["found"] and a["degenerate"] == b["degenerate"]
    assert int(ra.leaf_id) == int(rb.leaf_id)
    np.testing.assert_array_equal(np.asarray(ra.grasp_uv), rb.grasp_uv)
    assert a["frame_index"] == b["frame_index"]
    pa, pb = a["message"].split(","), b["message"].split(",")
    assert len(pa) == len(pb) == 8 and pa[:2] == pb[:2]
    np.testing.assert_allclose([float(x) for x in pb[2:]],
                               [float(x) for x in pa[2:]], rtol=0,
                               atol=1e-4)


# ---- the two services on one stream --------------------------------------------

@pytest.mark.parametrize("mode", ["union", "union_half"])
def test_service_cv_only_matches_jax(mode):
    jm, tm = [], []
    js = JGraspService(_cfg(jcfg, isolation_context=mode), publish=jm.append,
                       min_interval_s=0.0)
    ts = _service(cfg=_cfg(tcfg, isolation_context=mode), publish=tm.append)
    kernels.reset_launch_counts()
    for i, (mask, depth) in enumerate(_stream()):
        for svc in (js, ts):
            svc.on_mask(mask, stamp_us=i)
            svc.on_depth(depth, stamp_us=10 + i)
        a = js.process_pending(force=True)
        b = ts.process_pending(force=True)
        assert b is not None and b["found"] and not b["degenerate"]
        assert (b["mask_stamp"], b["depth_stamp"]) == (i, 10 + i)
        _assert_same_out(a, b)
        u, v = b["result"].grasp_uv
        assert mask[v, u] == int(b["result"].leaf_id)
    assert len(tm) == len(jm) == 4
    stats = ts.stats()
    assert stats["frames"] == 4 and stats["bus"]["pairs"] == 4
    assert {"frame_total", "select_grasp", "fetch",
            "finalize"} <= set(stats["stages"])
    assert set(kernels.launch_counts().values()) == {0}


def test_service_with_cnn_matches_jax():
    from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    _, variables = init_grasp_cnn(jax.random.PRNGKey(0),
                                  jcfg.DEFAULT_CONFIG.model)
    model = GraspPointCNN(tcfg.ModelConfig()).eval()
    model.load_state_dict(flax_to_torch_grasp_cnn(
        jax.tree.map(np.asarray, variables)))
    js = JGraspService(JCFG, cnn_variables=variables, min_interval_s=0.0)
    ts = _service(cnn=model)
    for mask, depth in _stream(n=1):
        a = js.process_frame(mask, depth)
        b = ts.process_frame(mask, depth)
        assert bool(b["result"].ml_used) and bool(a["result"].ml_used)
        _assert_same_out(a, b)
    # the result handed to callbacks has numpy leaves all the way down
    res = b["result"]
    assert isinstance(res.grasp_xyz, np.ndarray)
    assert isinstance(res.leaf_selection.stats.area, np.ndarray)
    assert isinstance(res.fusion.combined, np.ndarray)


def test_service_hist_median_publishes_the_default_messages():
    """``hist_median=True`` reaches leaf selection through the service and
    the frame function, and the histogram medians (within 1e-5 m of the
    bisection's) pick the same leaves, so the messages are the same."""
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    base, hist = [], []
    a, b = _service(publish=base.append), \
        _service(publish=hist.append, hist_median=True)
    span_tol = 1.0 / 256 ** 2
    for mask, depth in _stream():
        ra = a.process_frame(mask, depth)["result"]
        rb = b.process_frame(mask, depth)["result"]
        ma = ra.leaf_selection.stats.median_depth
        mb = rb.leaf_selection.stats.median_depth
        present = ra.leaf_selection.stats.present
        assert present.any() and not np.array_equal(ma, mb)
        np.testing.assert_allclose(
            mb[present], ma[present], rtol=0,
            atol=float(depth.max() - depth.min()) * span_tol + 1e-5)
        np.testing.assert_array_equal(ra.leaf_selection.is_tall,
                                      rb.leaf_selection.is_tall)
    assert hist == base and len(base) == 4
    mask, depth = _stream(1)[0]
    args = (mask, depth, np.float32(W / 2), np.float32(H / 2),
            np.float32(400.0))
    fa = make_frame_fn(TCFG, device="cpu")(*args)
    fb = make_frame_fn(TCFG, device="cpu", hist_median=True)(*args)
    assert int(fa.leaf_id) == int(fb.leaf_id) > 0
    assert torch.equal(fa.grasp_uv, fb.grasp_uv)
    assert not torch.equal(fa.leaf_selection.stats.median_depth,
                           fb.leaf_selection.stats.median_depth)


def test_service_cnn_and_device_checks(monkeypatch):
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    model = GraspPointCNN(tcfg.ModelConfig(encoder_filters=(8, 16)))
    with pytest.raises(ValueError, match="eval"):
        _service(cnn=model.train())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraspService(TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraspService(TCFG, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.setup()


# ---- gate, pipeline depth, threads ----------------------------------------------

def test_service_rate_gate():
    mask, depth = _stream(1)[0]
    svc = _service(min_interval_s=1e6)
    assert svc.process_pending(force=True) is None        # nothing pushed
    for _ in range(2):
        svc.on_mask(mask)
        svc.on_depth(depth)
        first = svc.process_pending(force=True) if svc.stats()["frames"] == 0 \
            else svc.process_pending()
    assert first is None                                  # gated
    assert svc.stats()["frames"] == 1
    svc.on_mask(mask)
    assert svc.process_pending(force=True) is not None    # pair still there


def test_service_pipeline_depth_order_and_flush():
    frames = _stream()
    sync_msgs = []
    svc_sync = _service(publish=sync_msgs.append)
    for m, d in frames:
        svc_sync.process_frame(m, d)

    msgs, results = [], []
    svc = _service(publish=msgs.append, on_result=results.append,
                   pipeline_depth=2)
    outs = [svc.process_frame(m, d) for m, d in frames]
    assert outs[0] is None and outs[1] is None            # window filling
    assert outs[2]["frame_index"] == 0
    assert outs[3]["frame_index"] == 1
    tail = svc.flush()
    assert [t["frame_index"] for t in tail] == [2, 3]
    assert not svc._inflight and svc.flush() == []
    assert [r["frame_index"] for r in results] == [0, 1, 2, 3]
    assert msgs == sync_msgs


class _StubSelector:
    """Duck-typed hybrid selector: picks the candidate of leaf ``leaf``
    (the last candidate when None) and remembers what it was shown."""

    def __init__(self, leaf=None, fail=False):
        self.leaf, self.fail, self.calls = leaf, fail, []

    def select_grasp_point(self, rgb, candidates):
        self.calls.append((rgb, [dict(c) for c in candidates]))
        if self.fail:
            raise RuntimeError("selector down")
        pick = [c for c in candidates if c["leaf_id"] == self.leaf] \
            or candidates[-1:]
        choice = dict(pick[0])
        choice["strategy"] = "stub"
        return choice


def test_service_rerank_and_reselect_match_jax():
    mask, depth = _stream(1)[0]
    rgb = np.zeros((H, W, 3), np.uint8)
    stubs = _StubSelector(), _StubSelector()
    js = JGraspService(JCFG, hybrid_selector=stubs[0], min_interval_s=0.0)
    ts = _service(hybrid_selector=stubs[1])
    plain = _service().process_frame(mask, depth)
    for svc in (js, ts):
        svc.on_rgb(rgb)
    a, b = js.process_frame(mask, depth), ts.process_frame(mask, depth)
    # the stub saw the same candidates in both packages
    ca, cb = stubs[0].calls[0][1], stubs[1].calls[0][1]
    assert stubs[1].calls[0][0] is rgb
    assert [c["leaf_id"] for c in ca] == [c["leaf_id"] for c in cb]
    for x, y in zip(ca, cb):
        for key in ("x", "y", "clutter_score", "distance_score",
                    "visibility_score", "geometric_score"):
            assert abs(x[key] - y[key]) <= 1e-5, key
    geometric = int(plain["result"].leaf_id)
    assert len(cb) > 1 and geometric in [c["leaf_id"] for c in cb]
    # it chose the LAST candidate, so the pixel was reselected on that leaf
    assert b["vla"]["leaf_id"] == cb[-1]["leaf_id"] != geometric
    assert int(b["result"].leaf_id) == b["vla"]["leaf_id"]
    u, v = b["result"].grasp_uv
    assert mask[v, u] == b["vla"]["leaf_id"]
    assert "vla_reselect" in ts.stats()["stages"]
    _assert_same_out(a, b)
    # agreeing with the geometric choice reselects nothing
    agree = _service(hybrid_selector=_StubSelector(leaf=geometric))
    out = agree.process_frame(mask, depth)
    assert out["message"] == plain["message"]
    assert "vla_reselect" not in agree.stats()["stages"]
    # a failing selector degrades to the geometric choice
    down = _service(hybrid_selector=_StubSelector(fail=True))
    out = down.process_frame(mask, depth)
    assert out["vla"] is None and out["message"] == plain["message"]


def test_service_pipelined_rerank_keeps_order():
    frames = _stream()
    sync_msgs, msgs = [], []
    sync = _service(hybrid_selector=_StubSelector(), publish=sync_msgs.append)
    for m, d in frames:
        sync.process_frame(m, d)
    svc = _service(hybrid_selector=_StubSelector(), publish=msgs.append,
                   pipeline_depth=2)
    outs = [svc.process_frame(m, d) for m, d in frames]
    assert outs[0] is None and outs[2]["vla"] is not None
    tail = svc.flush()
    assert [t["frame_index"] for t in tail] == [2, 3]
    assert msgs == sync_msgs


def test_service_threaded_loop_and_stop_races_run(tmp_path):
    """``run()`` in a thread with ``pipeline_depth=2`` and a recorder;
    ``stop()`` from this thread mid-stream: every result in frame order,
    every recorded frame intact, no exception in either thread, and the
    launch counts untouched on the CPU."""
    mask, depth = _stream(1)[0]
    path = str(tmp_path / "race.fl")
    results, errors = [], []
    svc = _service(on_result=results.append, pipeline_depth=2,
                   record_path=path)

    def run():
        try:
            svc.run(poll_interval_s=0.0005)
        except Exception as exc:          # pragma: no cover
            errors.append(exc)

    kernels.reset_launch_counts()
    t = threading.Thread(target=run)
    t.start()
    try:
        for i in range(6):
            svc.on_mask(np.roll(mask, i, axis=1), stamp_us=i)
            svc.on_depth(np.roll(depth, i, axis=1), stamp_us=i)
            time.sleep(0.02)
        deadline = time.time() + 60
        while svc.stats()["frames"] == 0 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        svc.stop()                      # races the loop deliberately
        t.join(timeout=60)
    assert not t.is_alive() and not errors
    idxs = [r["frame_index"] for r in results]
    assert idxs == sorted(idxs) and len(idxs) > 0
    assert all(r["found"] for r in results)
    with tframelog.FrameLogReader(path) as rd:
        n_rec = sum(1 for _ in rd)
    assert n_rec >= len(results)
    assert svc._recorder is None and not svc._inflight
    assert set(kernels.launch_counts().values()) == {0}


# ---- record, replay, and logs across the packages -------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_service_record_and_replay_across_packages(tmp_path, writer):
    """A session recorded by one package's service replays through the
    other's with the same grasp pixels; the port's replay of its own log
    republishes identical messages."""
    from leafgrasp_tpu.io.framelog import FrameLogReader as JReader
    frames = _stream(n=2)
    p = str(tmp_path / "rec.lflg")
    live = []
    if writer == "jax":
        svc = JGraspService(JCFG, publish=live.append, min_interval_s=0.0,
                            record_path=p)
        reader_cls = tframelog.FrameLogReader
    else:
        svc = _service(publish=live.append, record_path=p)
        reader_cls = JReader
    for i, (m, d) in enumerate(frames):
        svc.process_frame(m, d, mask_stamp=100 + i)
    svc.stop()
    with pytest.raises(FileExistsError):
        tframelog.FrameLogWriter(p, H, W)

    replay = []
    svc2 = _service(publish=replay.append) if writer == "jax" else \
        JGraspService(JCFG, publish=replay.append, min_interval_s=0.0)
    with reader_cls(p) as rd:
        assert len(rd) == len(frames) and (rd.h, rd.w) == (H, W)
        for i, (m, d, st) in enumerate(rd):
            np.testing.assert_array_equal(m, frames[i][0])
            np.testing.assert_array_equal(d, frames[i][1])
            assert st == 100 + i
            svc2.process_frame(np.asarray(m), np.asarray(d), mask_stamp=st)
    assert [m.split(",")[:2] for m in replay] \
        == [m.split(",")[:2] for m in live]
    if writer == "torch":
        own = []
        svc3 = _service(publish=own.append)
        with tframelog.FrameLogReader(p) as rd:
            for m, d, st in rd:
                svc3.process_frame(np.asarray(m), np.asarray(d))
        assert own == live


@pytest.mark.parametrize("write_native,read_native",
                         [(True, True), (False, False), (True, False),
                          (False, True)])
def test_framelog_bytes_match_jax_package(tmp_path, write_native,
                                          read_native):
    """The same frames written by both packages give the same bytes, in
    the native and the numpy implementation alike."""
    from leafgrasp_tpu.io.framelog import FrameLogWriter as JWriter
    assert tframelog.native_available()
    rng = np.random.default_rng(0)
    h, w, n = 23, 37, 4                      # odd h*w: the mask is padded
    masks = rng.integers(0, 7, (n, h, w)).astype(np.int16)
    depths = rng.random((n, h, w)).astype(np.float32)
    pj, pt = str(tmp_path / "j.lflg"), str(tmp_path / "t.lflg")
    for cls, path in ((JWriter, pj), (tframelog.FrameLogWriter, pt)):
        with cls(path, h, w, prefer_native=write_native) as wr:
            for i in range(n):
                wr.append(masks[i], depths[i], stamp_us=1000 + i)
            assert len(wr) == n
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    with open(pt, "ab") as f:
        f.write(b"\x00" * 50)                # a torn trailing record
    with tframelog.FrameLogReader(pt, prefer_native=read_native) as rd:
        assert len(rd) == n
        for i in range(n):
            m, d, st = rd.frame(i)
            np.testing.assert_array_equal(m, masks[i])
            np.testing.assert_array_equal(d, depths[i])
            assert st == 1000 + i
        with pytest.raises(IndexError):
            rd.frame(n)
    with pytest.raises(ValueError):
        with tframelog.FrameLogWriter(pt, h, w, overwrite=True) as wr:
            wr.append(masks[0][:5], depths[0])


# ---- frame bus ------------------------------------------------------------------

@pytest.mark.parametrize("prefer_native", [True, False])
def test_framebus_pairing_latest_wins(prefer_native):
    bus = tframebus.FrameBus(4, 5, prefer_native=prefer_native)
    assert bus.is_native == prefer_native
    assert bus.try_get_pair() is None
    depth = np.linspace(0, 1, 20, dtype=np.float32).reshape(4, 5)
    for i in range(5):
        bus.push_mask(np.full((4, 5), i, np.int16), 100 + i)
    assert bus.try_get_pair() is None         # no depth yet
    bus.push_depth(depth, 222)
    m, d, ms, ds = bus.try_get_pair()
    assert (m == 4).all() and (ms, ds) == (104, 222)   # freshest mask won
    np.testing.assert_array_equal(d, depth)
    assert bus.try_get_pair() is None         # consumed
    stats = bus.stats()
    assert stats["mask_pushed"] == 5 and stats["mask_dropped"] == 4
    assert stats["depth_pushed"] == 1 and stats["pairs"] == 1
    bus.close()


def test_native_libraries_build_outside_native_dir():
    """The port compiles ``native/*.cpp`` into ``build/native/`` and
    leaves ``native/`` alone."""
    before = sorted(os.listdir(NATIVE_DIR))
    assert tframebus.native_available() and tframelog.native_available()
    assert sorted(os.listdir(NATIVE_DIR)) == before
    built = sorted(os.listdir(BUILD_DIR))
    assert any(f.startswith("libframebus_") for f in built)
    assert any(f.startswith("libframelog_") for f in built)
    assert BUILD_DIR.parent.name == "build"


def test_framebus_threaded_no_torn_frames():
    bus = tframebus.FrameBus(8, 8)
    n, stop, got = 200, threading.Event(), []

    def producer():
        for i in range(n):
            bus.push_mask(np.full((8, 8), i % 100, np.int16), i)
            bus.push_depth(np.full((8, 8), 0.5, np.float32), i)
        stop.set()

    t = threading.Thread(target=producer)
    t.start()
    while True:
        pair = bus.try_get_pair()
        if pair is None:
            if stop.is_set():
                break
            continue
        assert (pair[0] == pair[0][0, 0]).all()
        got.append(int(pair[0][0, 0]))
    t.join()
    s = bus.stats()
    assert s["mask_pushed"] == n and s["pairs"] == len(got) > 0
    bus.close()


# ---- helpers of the service -----------------------------------------------------

def test_message_candidates_and_compact_ids_match_jax():
    from leafgrasp_tpu.pipeline import ingest as jingest
    uv, xyz, pre = (10, 20), (0.1, 0.25, 0.5), np.float32([1, 2, 3])
    assert format_result_message(uv, xyz) \
        == jingest.format_result_message(uv, xyz)
    assert format_result_message(uv, xyz, pre) \
        == jingest.format_result_message(uv, xyz, pre)
    mask = np.zeros((20, 20), np.int32)
    mask[0:5, 0:5], mask[10:20, 10:20], mask[0:2, 10:12] = 37, 1042, 7
    out, lookup = compact_instance_ids(mask, max_leaves=2)
    jout, jlookup = jingest.compact_instance_ids(mask, max_leaves=2)
    np.testing.assert_array_equal(out, jout)
    assert lookup == jlookup == {1: 37, 2: 1042}
    m, d = _stream(1)[0]
    a = JGraspService(JCFG, min_interval_s=0.0).process_frame(m, d)
    b = _service().process_frame(m, d)
    ca = jingest.leaf_candidates(a["result"].leaf_selection, 3)
    cb = leaf_candidates(b["result"].leaf_selection, 3)
    assert [c["leaf_id"] for c in ca] == [c["leaf_id"] for c in cb]
    assert 1 <= len(cb) <= 3
    assert all(c["geometric_score"] >= cb[-1]["geometric_score"] for c in cb)


def test_fetch_to_host_keeps_structure_and_counts_one_read():
    from leafgrasp_tpu_torch.ops.topk import Candidates
    cand = Candidates(*(torch.arange(3) + i
                        for i in range(len(Candidates._fields))))
    tree = {"c": cand, "l": [torch.tensor(True), (torch.ones(2), 5)]}
    tdevice.reset_host_reads()
    out = tdevice.fetch_to_host(tree)
    assert tdevice.host_reads() == 1
    assert isinstance(out["c"], Candidates)
    assert all(isinstance(x, np.ndarray) for x in out["c"])
    np.testing.assert_array_equal(out["c"][1], [1, 2, 3])
    assert out["l"][0].dtype == np.bool_ and out["l"][1][1] == 5
    assert isinstance(out["l"][1], tuple)
    out["c"][0][0] = 9                     # copies, not views
    assert int(cand[0][0]) == 0


def test_scenes_match_jax():
    from leafgrasp_tpu.io import scenes as jscenes
    from leafgrasp_tpu_torch.io import scenes as tscenes
    for kw in (dict(height=120, width=160, num_leaves=5, seed=2),
               dict(height=33, width=47, num_leaves=3, seed=7, margin=200)):
        a = jscenes.make_hard_leaf_scene(**kw)
        b = tscenes.make_hard_leaf_scene(**kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(jscenes.default_projection(),
                                  tscenes.default_projection())
    cam = tcfg.CameraConfig.from_projection(tscenes.default_projection())
    assert abs(cam.fx - 1750.68) < 1e-9 and abs(cam.cx - 707.87) < 1e-9


# ---- the smaller modules --------------------------------------------------------

def test_sdf_helper_matches_jax():
    from leafgrasp_tpu.geometry import sdf_helper as jsdf
    from leafgrasp_tpu_torch.geometry import sdf_helper as tsdf
    mask, _ = make_leaf_scene(height=96, width=160, num_leaves=3, seed=4,
                              margin=20)
    leaf, union = mask == 2, mask > 0
    np.testing.assert_array_equal(tsdf.global_sdf(_t(union)).numpy(),
                                  np.asarray(jsdf.global_sdf(union)))
    np.testing.assert_array_equal(tsdf.leaf_sdf(_t(leaf)).numpy(),
                                  np.asarray(jsdf.leaf_sdf(leaf)))
    ys, xs = np.nonzero(leaf)
    for k in (0, len(xs) // 2, len(xs) - 1):
        uv = (int(xs[k]), int(ys[k]))
        np.testing.assert_allclose(
            tsdf.approach_vector(_t(leaf), uv).numpy(),
            np.asarray(jsdf.approach_vector(leaf, uv)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(tsdf.isolation_metric(_t(leaf), _t(union))),
        float(jsdf.isolation_metric(leaf, union)), rtol=1e-6)
    # a flat field has no gradient: the default direction
    full = torch.ones((12, 12), dtype=torch.bool)
    assert tsdf.approach_vector(full, (5, 5)).tolist() == [0.0, -1.0]


def test_simple_scorer_matches_jax():
    from leafgrasp_tpu.geometry.simple_scorer import select_leaf_simple as jsel
    from leafgrasp_tpu_torch.geometry.simple_scorer import select_leaf_simple
    mask, depth = _stream(1)[0]
    kw = dict(max_leaves=8, min_area=1500)
    a = jsel(mask, depth, **kw)
    b = select_leaf_simple(_t(mask), _t(depth), **kw)
    assert int(a.best_leaf_id) == int(b.best_leaf_id) > 0
    assert bool(b.found)
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
    np.testing.assert_array_equal(np.asarray(a.centroid_uv),
                                  b.centroid_uv.numpy())
    valid = b.valid.numpy()
    # 1/variance amplifies the last bits of the f32 sums: 1e-4 relative
    np.testing.assert_allclose(b.scores.numpy()[valid],
                               np.asarray(a.scores)[valid], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.total.numpy()[valid],
                               np.asarray(a.total)[valid], rtol=1e-4)
    none = select_leaf_simple(_t(mask), _t(depth), max_leaves=8,
                              min_area=10 ** 7)
    assert not bool(none.found) and int(none.best_leaf_id) == 0


def test_predictor_matches_jax(tmp_path):
    from leafgrasp_tpu.models.predictor import GraspQualityPredictor as JPred
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    jc = jcfg.ModelConfig(encoder_filters=(8, 16), attention_type="hybrid")
    tc = tcfg.ModelConfig(encoder_filters=(8, 16), attention_type="hybrid")
    jp = JPred(jc, seed=3)
    sd = flax_to_torch_grasp_cnn(jax.tree.map(np.asarray, jp.variables))
    tp = GraspQualityPredictor(tc, state_dict=sd, device="cpu")
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(6, 32, 32, 9)).astype(np.float32)
    got = tp.predict_batch(feats)
    assert got.shape == (6,) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, jp.predict_batch(feats), rtol=0,
                               atol=1e-5)
    patch = {"depth_patch": feats[0, :, :, 0], "mask_patch": feats[0, :, :, 1],
             "score_patches": np.moveaxis(feats[0, :, :, 2:], -1, 0)}
    assert abs(tp.predict(patch) - jp.predict(patch)) <= 1e-5
    assert abs(tp.predict(patch) - float(got[0])) <= 1e-6
    # a saved state_dict loads back; seeded weights differ from it
    path = str(tmp_path / "cnn.pt")
    torch.save({"state_dict": sd}, path)
    other = GraspQualityPredictor(tc, seed=1, device="cpu")
    assert np.abs(other.predict_batch(feats) - got).max() > 1e-4
    np.testing.assert_array_equal(other.load(path).predict_batch(feats), got)


def test_visualizer_matches_jax(tmp_path):
    from leafgrasp_tpu.pipeline.visualizer import LeafVisualizer as JVis
    from leafgrasp_tpu_torch.pipeline.visualizer import (LeafVisualizer,
                                                         generate_color)
    mask, _ = _stream(1)[0]
    kw = dict(selected_leaf=3, grasp_uv=(150, 120),
              grasp_xyz=(0.1, 0.05, 0.5), pre_grasp_xyz=(0.05, 0.02, 0.5),
              tall_leaves=[1])
    vis = LeafVisualizer(str(tmp_path))
    frame = vis.render(mask, **kw)
    assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, JVis().render(mask, **kw))
    sel_px = frame[mask == 3]
    assert (sel_px[:, 0] > sel_px[:, 2]).mean() > 0.8     # selected is red
    rgb = np.zeros((H, W, 3), np.uint8)
    comp = vis.render(mask, 3, rgb=rgb)
    assert comp.shape == (H, 2 * W, 3)
    np.testing.assert_array_equal(comp, JVis().render(mask, 3, rgb=rgb))
    path = vis.visualize_result(mask, 3, (150, 120), (0.1, 0.05, 0.5),
                                (0.05, 0.02, 0.5), tall_leaves=[1])
    assert os.path.exists(path)
    with pytest.raises(ValueError):
        LeafVisualizer().save(frame)
    assert len({generate_color(i) for i in range(1, 12)}) == 11


def _ridged_leaf(h=220, w=320, theta=0.5, cx=160, cy=110, a=90, b=32):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ct, st = np.cos(theta), np.sin(theta)
    xr = (xx - cx) * ct + (yy - cy) * st
    yr = -(xx - cx) * st + (yy - cy) * ct
    mask = (xr / a) ** 2 + (yr / b) ** 2 <= 1
    img = np.zeros((h, w), np.float32)
    img[mask] = 0.35
    img[mask & (np.abs(yr) < 2.5)] = 1.0
    return mask, img


@pytest.mark.parametrize("theta", [0.2, 1.0, 2.3])
def test_tools_match_jax(theta):
    from leafgrasp_tpu.io import tools as jtools
    from leafgrasp_tpu_torch.io import tools as ttools
    mask, img = _ridged_leaf(theta=theta)
    got = ttools.detect_midrib(mask, img)
    assert got is not None and got == jtools.detect_midrib(mask, img)
    (x1, y1), (x2, y2) = got
    ang = np.degrees(np.arctan2(y2 - y1, x2 - x1)) % 180
    d = abs(ang - np.degrees(theta) % 180)
    assert min(d, 180 - d) < 8
    clicked = ((70, 80), (250, 140))
    a, b = jtools.angle_error(mask, clicked), ttools.angle_error(mask, clicked)
    assert a["valid"] == b["valid"] is True
    for key in ("manual_deg", "estimated_deg", "error_deg"):
        assert abs(a[key] - b[key]) <= 1e-3, key
    batch = ttools.quantify_angles(mask.astype(np.int16) * 2, {2: clicked})
    assert batch[0]["leaf_id"] == 2
    assert abs(batch[0]["error_deg"] - b["error_deg"]) <= 1e-9
    assert ttools.detect_midrib(np.zeros_like(mask), img) is None


def test_replay_matches_jax(tmp_path):
    from PIL import Image
    from leafgrasp_tpu.io import replay as jreplay
    from leafgrasp_tpu_torch.io import replay as treplay
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 9, 12).astype(np.int16)
    np.testing.assert_array_equal(treplay.decode_mask_buffer(buf, 3, 4),
                                  jreplay.decode_mask_buffer(buf, 3, 4))
    fbuf = rng.random(12).astype(np.float32)
    np.testing.assert_array_equal(treplay.decode_depth_buffer(fbuf, 3, 4),
                                  jreplay.decode_depth_buffer(fbuf, 3, 4))
    rgb = np.zeros((6, 8, 3), np.uint8)
    rgb[1:3, 1:4] = (200, 10, 10)
    rgb[4:, 5:] = (10, 200, 10)
    gray = rgb[:, :, 1]
    for arr in (rgb, gray):
        np.testing.assert_array_equal(treplay.color_keyed_to_ids(arr),
                                      jreplay.color_keyed_to_ids(arr))
    assert set(np.unique(treplay.color_keyed_to_ids(rgb))) == {0, 1, 2}
    for no in (2, 5):
        Image.fromarray(np.roll(rgb, no, axis=1)).save(
            str(tmp_path / f"mask{no}.png"))
        np.save(str(tmp_path / f"depth{no}.npy"), rng.random((6, 8)))
    np.save(str(tmp_path / "depth9.npy"), rng.random((6, 8)))  # no mask
    got = list(treplay.replay_directory(str(tmp_path)))
    want = list(jreplay.replay_directory(str(tmp_path)))
    assert [g[2] for g in got] == [2, 5]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g[0], w_[0])
        np.testing.assert_array_equal(g[1], w_[1])
        assert g[1].dtype == np.float32


def test_stage_timer_and_trace():
    from leafgrasp_tpu_torch.utils.profiler import StageTimer, span
    t = StageTimer()
    with t.stage("a"):
        pass
    t.record("a", 0.01)
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["max_ms"] >= 10.0
    assert "a" in t.report()
    # a span records into the bound timer only, and binding nests
    inner = StageTimer()
    with span("b"):
        pass
    with t.bound():
        with span("b"):
            with inner.bound():
                with span("c"):
                    pass
            with span("b"):
                pass
    with span("b"):
        pass
    assert t.summary()["b"]["count"] == 2 and "c" not in t.summary()
    assert set(inner.summary()) == {"c"}


FRAME_STAGES = ("upload", "leaf_select", "score_maps", "candidates", "cnn",
                "lift")


def _cnn_service():
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    torch.manual_seed(0)
    cnn = GraspPointCNN(tcfg.ModelConfig(encoder_filters=(8, 16))).eval()
    return _service(cnn=cnn)


def _push_and_process(svc, mask, depth, stamp=1):
    svc.on_mask(mask, stamp)
    svc.on_depth(depth, stamp)
    return svc.process_pending(force=True)


def test_service_frame_records_its_stage_spans():
    svc = _cnn_service()
    mask, depth = _stream(1)[0]
    out = _push_and_process(svc, mask, depth)
    assert out is not None and out["found"]
    st = svc.stats()["stages"]
    for name in FRAME_STAGES:
        assert st[name]["count"] == 1, name
    assert st["bus_push"]["count"] == 2 and st["bus_pair"]["count"] == 1
    assert st["device_wait"]["count"] >= 1
    assert sum(st[n]["total_s"] for n in FRAME_STAGES) \
        <= st["select_grasp"]["total_s"]


def test_frame_fn_without_a_bound_timer_records_nothing(monkeypatch):
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.utils import profiler
    seen = []
    monkeypatch.setattr(profiler.StageTimer, "record",
                        lambda self, name, s: seen.append(name))
    cnn = GraspPointCNN(tcfg.ModelConfig(encoder_filters=(8, 16))).eval()
    mask, depth = _stream(1)[0]
    res = make_frame_fn(TCFG, with_cnn=True, device="cpu")(
        mask, depth, np.float32(W / 2), np.float32(H / 2), np.float32(400.0),
        cnn)
    assert bool(res.found)
    assert seen == []


def test_service_spans_nest_in_a_profile():
    from torch.profiler import ProfilerActivity, profile
    from leafgrasp_tpu_torch.utils.profiler import SPAN_PREFIX
    svc = _cnn_service()
    mask, depth = _stream(1)[0]
    _push_and_process(svc, mask, depth)            # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _push_and_process(svc, mask, depth, 2)
    ranges = {}
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            assert e.is_user_annotation, e.name
            ranges.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    for name in ("frame_total", "select_grasp", "fetch", "finalize",
                 "bus_push", "bus_pair", "device_wait") + FRAME_STAGES:
        assert name in ranges, name
    (outer,), (sel,) = ranges["frame_total"], ranges["select_grasp"]
    assert outer[0] <= sel[0] and sel[1] <= outer[1]
    for name in FRAME_STAGES:
        (a, b), = ranges[name]
        assert sel[0] <= a and b <= sel[1], name


def test_spans_build_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    svc = _cnn_service()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    mask, depth = _stream(1)[0]
    assert _push_and_process(svc, mask, depth)["found"]
    assert svc.stats()["stages"]["lift"]["count"] == 1


def test_stage_timer_record_is_thread_safe():
    import sys
    from leafgrasp_tpu_torch.utils.profiler import StageTimer
    t = StageTimer()

    def work():
        for _ in range(10_000):
            t.record("x", 1e-6)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert t.summary()["x"]["count"] == 40_000
    assert t.summary()["x"]["total_s"] == pytest.approx(0.04)


def test_device_utils_on_cpu():
    info = tdevice.device_info("cpu")
    assert info == tdevice.setup("cpu")
    assert info["backend"] == "cpu" and info["device_count"] == 1
    arr = tdevice.to_device(np.ones((4, 4)), "cpu")
    assert isinstance(arr, torch.Tensor) and float(arr.sum()) == 16
    assert tdevice.live_buffer_bytes() >= 0
    tdevice.clear_memory()
