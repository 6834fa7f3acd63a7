"""The port's self-supervised lifecycle against the JAX package, on the
CPU at 270 x 360: the counterparts of tests/test_lifecycle.py
(teacher -> collector -> ``Trainer.fit`` -> checkpoint -> the restored
CNN serving in ``make_frame_fn``) and of
tests/test_aux_components.py ``test_collect_from_framelog_session`` (a
recorded framelog session feeding the teacher).

Held against JAX on the same frames: the frames used, each positive's
teacher point (equal) and score (1e-5 absolute, as
tests/test_torch_collector.py), the number of samples; then the served
frame's leaf and its top-k candidate pixels, which the CNN does not
move, equal JAX's CV path, and the fused pixel is one of them. The fits
themselves differ (each package draws its own initial weights and
shuffles), so the trained CNN is held to the JAX test's properties:
a finite validation loss, a bit-equal checkpoint round trip and a pixel
on the selected leaf.
"""

import numpy as np
import torch

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from leafgrasp_tpu.io.scenes import make_leaf_scene
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CX, CY, F = 180.0, 135.0, 800.0
H, W = 270, 360
SEEDS = (3, 5, 8, 13)


def _cfg(pkg):
    return pkg.PipelineConfig(
        frame=pkg.FrameConfig(height=H, width=W, max_leaves=8),
        leaf=pkg.LeafSelectionConfig(min_leaf_area=1500),
        model=pkg.ModelConfig(encoder_filters=(8, 16),
                              attention_type="spatial"))


def _positives(ds):
    sel = np.where((ds["labels"] == 1) & ~ds["is_augmented"])[0]
    return ds["grasp_points"][sel], ds["total_scores"][sel]


def _same_collection(got, want):
    gp, gs = _positives(got)
    wp, ws = _positives(want)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    assert len(got["labels"]) == len(want["labels"])
    assert int(got["labels"].sum()) == int(want["labels"].sum())


def test_full_self_supervised_lifecycle_matches_jax(tmp_path):
    from leafgrasp_tpu.pipeline.frame import make_frame_fn as j_frame_fn
    from leafgrasp_tpu.training.data_collector import \
        GraspDataCollector as JCollector
    from leafgrasp_tpu.training.teacher import collect_from_frames as \
        j_collect
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.training import (GraspDataCollector, Trainer,
                                              collect_from_frames,
                                              verify_dataset)
    from leafgrasp_tpu_torch.training.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    # 1) the teacher labels the frames, in both packages
    frames = [make_leaf_scene(H, W, 4, seed=s, margin=40) for s in SEEDS]
    coll = GraspDataCollector(str(tmp_path / "port"), resume=False,
                              save_every=1000, device="cpu")
    jcoll = JCollector(str(tmp_path / "jax"), resume=False, save_every=1000)
    used = collect_from_frames(frames, coll, CX, CY, F, _cfg(tcfg))
    assert used == j_collect(frames, jcoll, CX, CY, F, _cfg(jcfg)) >= 3
    data = coll.dataset()
    _same_collection(data, jcoll.dataset())
    assert verify_dataset(data)["ok"]

    # 2) a small CNN trains on the collected set
    model_cfg = _cfg(tcfg).model
    trainer = Trainer(model_cfg=model_cfg,
                      cfg=tcfg.TrainConfig(batch_size=8, learning_rate=1e-3),
                      device="cpu")
    result = trainer.fit(data, epochs=4)
    assert np.isfinite(result.best_val_loss)

    # 3) checkpoint round trip
    path = save_checkpoint(str(tmp_path / "ckpt"),
                           result.model.state_dict(),
                           norm_stats=result.norm_stats,
                           metrics=result.metrics, epoch=result.best_epoch)
    restored = load_checkpoint(path)
    model = GraspPointCNN(model_cfg)
    model.load_state_dict(restored["state_dict"])
    model.eval()
    for key, val in result.model.state_dict().items():
        assert torch.equal(restored["state_dict"][key], val), key

    # 4) the restored model serves inside the frame function
    mask, depth = frames[0]
    res = make_frame_fn(_cfg(tcfg), with_cnn=True, device="cpu")(
        mask, depth, CX, CY, F, model)
    assert bool(res.found) and not bool(res.degenerate) and bool(res.ml_used)
    u, v = res.grasp_uv.tolist()
    assert mask[v, u] == int(res.leaf_id)
    assert res.fusion.combined.shape[0] == _cfg(tcfg).grasp.top_k
    want = j_frame_fn(_cfg(jcfg))(mask, depth, np.float32(CX),
                                  np.float32(CY), np.float32(F))
    assert int(res.leaf_id) == int(want.leaf_id)
    got_c = np.stack([res.candidates.x.numpy(), res.candidates.y.numpy()])
    want_c = np.stack([np.asarray(want.candidates.x),
                       np.asarray(want.candidates.y)])
    np.testing.assert_array_equal(got_c, want_c)
    assert [u, v] in got_c.T.tolist()


def test_collect_from_framelog_session_matches_jax(tmp_path):
    from leafgrasp_tpu.io.framelog import FrameLogWriter as JWriter
    from leafgrasp_tpu.training.data_collector import \
        GraspDataCollector as JCollector
    from leafgrasp_tpu.training.teacher import collect_from_frames as \
        j_collect
    from leafgrasp_tpu_torch.io.framelog import FrameLogReader, FrameLogWriter
    from leafgrasp_tpu_torch.training import (GraspDataCollector,
                                              collect_from_frames)
    cfg = _cfg(tcfg).replace(model=tcfg.ModelConfig())
    jcfg_ = _cfg(jcfg).replace(model=jcfg.ModelConfig())
    scenes = [make_leaf_scene(H, W, num_leaves=4, seed=s, margin=40)
              for s in (3, 5)]
    p = str(tmp_path / "sess.lflg")
    with FrameLogWriter(p, H, W) as wr:
        for seed, (mask, depth) in zip((3, 5), scenes):
            wr.append(mask.astype(np.int16), depth, seed)
    # the JAX writer writes the same bytes
    pj = str(tmp_path / "sess_jax.lflg")
    with JWriter(pj, H, W) as wr:
        for seed, (mask, depth) in zip((3, 5), scenes):
            wr.append(mask.astype(np.int16), depth, seed)
    assert open(p, "rb").read() == open(pj, "rb").read()

    collector = GraspDataCollector(str(tmp_path / "port"), patch_size=32,
                                   device="cpu")
    with FrameLogReader(p) as rd:
        used = collect_from_frames(((m, d) for m, d, _ in rd), collector,
                                   CX, CY, F, cfg=cfg)
    jcoll = JCollector(str(tmp_path / "jax"), patch_size=32)
    assert used == j_collect(scenes, jcoll, CX, CY, F, cfg=jcfg_) == 2
    assert len(collector.samples) > 0
    _same_collection(collector.dataset(), jcoll.dataset())
