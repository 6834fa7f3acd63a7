"""The timed path broken underneath a whole run (the card check
skipped, everything else as a run does it): each fault the cell can have
must make ``correct`` false. A step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer, a
token or the re-picked leaf altered where it is produced. (No cell spans chips, so none can
leave out an exchange between them.)"""

import pytest
import torch

from benchmark.core import spec
from benchmark.tests.tiny import tiny_run


def test_sound_runs_are_correct():
    for name in ("frame.union.mixed", "cnn.train.b16"):
        assert tiny_run(name)[2]["correct"] is True


def test_frame_answer_altered(monkeypatch):
    from leafgrasp_tpu_torch.pipeline import frame
    orig = frame.select_grasp

    def moved(*args, **kwargs):
        res = orig(*args, **kwargs)
        return res._replace(grasp_uv=res.grasp_uv + torch.tensor(
            [1, 0], dtype=res.grasp_uv.dtype))
    monkeypatch.setattr(frame, "select_grasp", moved)
    _, limits, line = tiny_run("frame.union.mixed")
    assert line["correct"] is False
    assert line["limits"]["pixel_gap"]["value"] == 1.0


def test_frame_leaf_altered(monkeypatch):
    from leafgrasp_tpu_torch.pipeline import frame
    orig = frame.select_grasp

    def other_leaf(*args, **kwargs):
        res = orig(*args, **kwargs)
        return res._replace(leaf_id=res.leaf_id % 5 + 1)
    monkeypatch.setattr(frame, "select_grasp", other_leaf)
    _, _, line = tiny_run("frame.union.mixed")
    assert line["correct"] is False
    assert line["limits"]["leaf_gap"]["value"] > \
        line["limits"]["leaf_gap"]["limit"]


def test_train_state_unchanged(monkeypatch):
    from leafgrasp_tpu_torch.training import train
    monkeypatch.setattr(train, "optimizer_step", lambda *a, **k: None)
    _, _, line = tiny_run("cnn.train.b16")
    assert line["correct"] is False
    assert line["limits"]["change_med_rel"]["value"] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    from leafgrasp_tpu_torch.training import train
    orig = train.bce_with_logits

    def half(logits, labels, pos_weight, mask=None):
        n = logits.shape[0] // 2
        return orig(logits[:n], labels[:n], pos_weight,
                    None if mask is None else mask[:n])
    monkeypatch.setattr(train, "bce_with_logits", half)
    _, _, line = tiny_run("cnn.train.b16")
    assert line["correct"] is False
    assert line["limits"]["loss1_rel"]["value"] > \
        line["limits"]["loss1_rel"]["limit"]


def test_vla_token_altered(monkeypatch):
    from leafgrasp_tpu_torch.vla import llava_runtime
    orig = llava_runtime.greedy_generate_llava

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[:, 1] = (out[:, 1] + 1) % 100
        return out
    sound = tiny_run("vla.anyres.bf16")[2]
    assert sound["correct"] is True
    monkeypatch.setattr(llava_runtime, "greedy_generate_llava", altered)
    # the tiny model's logits spread over a few tenths, not the 7B's
    # units: its limit is held at the sound run's reading
    cell = spec.resolve("vla.anyres.bf16")
    cell.limits = dict(cell.limits, token_gap=max(
        sound["limits"]["token_gap"]["value"], 1e-6))
    _, _, line = tiny_run("vla.anyres.bf16", cell=cell)
    assert line["correct"] is False
    assert line["limits"]["token_gap"]["value"] > \
        line["limits"]["token_gap"]["limit"]


def test_vla_repick_altered(monkeypatch):
    from leafgrasp_tpu_torch.vla import hybrid
    orig = hybrid.HybridSelector.select_best_candidate

    def next_one(self, candidates, *args, **kwargs):
        best = orig(self, candidates, *args, **kwargs)
        ids = [c["leaf_id"] for c in candidates]
        k = (ids.index(best["leaf_id"]) + 1) % len(ids)
        return dict(best, **candidates[k])
    monkeypatch.setattr(hybrid.HybridSelector, "select_best_candidate",
                        next_one)
    run, _, line = tiny_run("vla.anyres.bf16", seed=8)
    assert line["correct"] is False
    assert line["limits"]["repick_differs"]["value"] >= 1
