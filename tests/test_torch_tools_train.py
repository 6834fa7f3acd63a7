"""The port's training CLIs (``tools/*_torch.py``) on the CPU at a tiny
size: each ``main`` runs and writes what its JAX counterpart writes, in
the formats the JAX package reads where the two share one.

The corpus tool is held against JAX's ``tools/make_training_corpus.py``
at the same arguments: the same frames used and the same labels,
augmentation flags and counts; every positive's point, depth, mask and
score patches (1e-6, 1e-6, 1e-5: the score maps agree to 1e-5) and
total score (1e-5); every augmentation's point, mask and score patches.
The augmentations' depth noise and score jitter and the negative picked
from each pool come from each package's own generator (numpy's, JAX's
threefry keys; ``training/data_collector.py``), so there only the
counts, the jitter's range and the negatives' zero score are held.
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import make_training_corpus_torch as corpus_t  # noqa: E402
from tools import run_cnn_sweep_torch as sweep_t  # noqa: E402
from tools import train_best_config_torch as best_t  # noqa: E402
from tools import train_reference_model_torch as ref_t  # noqa: E402
from tools import train_vla_sweep_torch as vla_t  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: F401,E402

HARD_CORPUS = os.path.join(ROOT, "artifacts", "grasp_cnn_hard",
                           "training_data", "training_data.npz")


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """The stored hard corpus's first 48 samples, as a corpus file."""
    with np.load(HARD_CORPUS) as data:
        cut = {k: data[k][:48] for k in data.files}
    assert 0 < int(cut["labels"].sum()) < 48
    path = tmp_path_factory.mktemp("corpus") / "training_data.npz"
    np.savez(path, **cut)
    return str(path)


def _reload(path, filters):
    from leafgrasp_tpu_torch.config import ModelConfig
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    return GraspQualityPredictor(ModelConfig(encoder_filters=filters),
                                 device="cpu").load(path)


def test_train_reference_model_writes_a_checkpoint(tmp_path):
    out = ref_t.main(["--device", "cpu", "--frames", "2", "--epochs", "1",
                      "--out", str(tmp_path)])
    assert out["epochs_run"] == 1 and out["device"] == "cpu"
    assert out["collection"]["positive_samples"] >= 1
    for name in ("best_model", "best_model.meta.json", "metrics.json",
                 "training_data/training_data.npz"):
        assert (tmp_path / name).exists(), name
    pred = _reload(out["checkpoint"], (64, 128, 256))
    assert pred.norm_stats is not None
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f)["samples"] == out["samples"]
    # resumable: the corpus already holds the frames, nothing is relabelled
    again = ref_t.main(["--device", "cpu", "--frames", "2", "--epochs",
                        "1", "--out", str(tmp_path)])
    assert again["samples"] == out["samples"]


def test_corpus_tool_gives_the_jax_tools_arrays(tmp_path):
    from tests.test_torch_tools_eval import jax_tool
    argv = ["--frames", "4", "--fresh"]
    with jax_tool("tools.make_training_corpus",
                  argv + ["--out", str(tmp_path / "jax")]) as tool:
        tool.main()
    out = corpus_t.main(argv + ["--device", "cpu", "--out",
                                str(tmp_path / "torch")])
    with np.load(tmp_path / "jax" / "training_data.npz") as f:
        want = {k: f[k] for k in f.files}
    with np.load(out["path"]) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for key in ("labels", "is_augmented"):
        np.testing.assert_array_equal(got[key], want[key])
    assert out["positive"] >= 8          # at least two frames used
    pos = (got["labels"] == 1) & ~got["is_augmented"]
    aug = got["is_augmented"]
    neg = got["labels"] == 0
    np.testing.assert_array_equal(got["grasp_points"][pos | aug],
                                  want["grasp_points"][pos | aug])
    np.testing.assert_allclose(got["total_scores"][pos],
                               want["total_scores"][pos], rtol=0, atol=1e-5)
    for key, tol in (("depth_patches", 1e-6), ("mask_patches", 1e-6),
                     ("score_patches", 1e-5)):
        np.testing.assert_allclose(got[key][pos], want[key][pos], rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got["mask_patches"][aug],
                                  want["mask_patches"][aug])
    np.testing.assert_allclose(got["score_patches"][aug],
                               want["score_patches"][aug], rtol=0,
                               atol=1e-5)
    # each augmentation's score is its positive's times a jitter in
    # [0.95, 1.0]; the rows run positive, its three rotations, negatives
    for i in np.where(aug)[0]:
        p = max(j for j in np.where(pos)[0] if j < i)
        ratio = got["total_scores"][i] / got["total_scores"][p]
        assert 0.95 - 1e-6 <= ratio <= 1.0 + 1e-6
    assert np.all(got["total_scores"][neg] == 0.0)


def test_train_best_config_writes_a_checkpoint(tmp_path, small_corpus):
    out = best_t.main(["--device", "cpu", "--data", small_corpus,
                       "--arch", "lightweight", "--epochs", "1",
                       "--out", str(tmp_path)])
    assert out["config"]["arch"] == "lightweight"
    assert out["samples"] == 48 and out["epochs_run"] == 1
    pred = _reload(out["checkpoint"], (32, 64, 128))
    with np.load(small_corpus) as data:
        score = pred.predict({"depth_patch": data["depth_patches"][0],
                              "mask_patch": data["mask_patches"][0],
                              "score_patches": data["score_patches"][0]})
    assert 0.0 <= score <= 1.0


def test_cnn_sweep_writes_its_store(tmp_path, small_corpus):
    out = sweep_t.main(["--device", "cpu", "--data", small_corpus,
                        "--limit", "2", "--epochs", "1",
                        "--out", str(tmp_path)])
    assert out["runs"] == 2
    with open(tmp_path / "leafgrasp-tpu.jsonl") as f:
        runs = [json.loads(line) for line in f]
    assert len(runs) == 2 and {r["run"] for r in runs} >= {out["best"]}
    with open(out["summary"]) as f:
        assert len(json.load(f)["top"]) == 2


def test_vla_sweep_writes_the_jax_formats(tmp_path):
    out = vla_t.main(["--device", "cpu", "--num-train", "4", "--num-eval",
                      "2", "--pretrain-epochs", "1", "--out",
                      str(tmp_path)])
    names = [r["experiment"] for r in out["experiments"]]
    assert names == ["baseline_5e5", "higher_lr_1e4", "larger_rank_16",
                     "optimized_config"]
    assert all(np.isfinite(r["final_loss"]) for r in out["experiments"])
    with np.load(tmp_path / "pretrained_base.npz") as got, \
            np.load(os.path.join(ROOT, "artifacts", "vla",
                                 "pretrained_base.npz")) as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
    for name in names:
        with np.load(tmp_path / name / "adapter.npz") as got, \
                np.load(os.path.join(ROOT, "artifacts", "vla", name,
                                     "adapter.npz")) as want:
            assert set(got.files) == set(want.files), name
        assert (tmp_path / name / "training_history.json").exists()
    assert (tmp_path / "sweep_summary.json").exists()
