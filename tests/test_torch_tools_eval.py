"""The port's evaluation and parity tools (``tools/*_torch.py``) against
the JAX package's tools and committed records, on the CPU at small sizes.

* The converted CNN checkpoints (``artifacts/torch/``) give the orbax
  models' logits on seeded patches: 1e-5 absolute (the convolutions sum
  in another order in each framework).
* ``parity_report_torch`` gives the committed PARITY.json rows of three
  golden scenes, the degenerate one among them; its own rule holds
  leaf, pixel and flag equal and the message within 1e-5 relative.
* ``fuzz_parity_torch``'s first three draws at 270 x 360 give JAX's
  ``make_frame_fn`` answer (found, degenerate, leaf, pixel equal, the
  message by the same rule) and, where not degenerate, the exact-mode
  oracle's pixel (tests/reference_impl.py, imported here, never by the
  tool).
* ``eval_system_accuracy_torch`` gives the rows of the JAX tool run
  here into ``tmp_path`` (plain and hard scenes): every leaf, pixel and
  teacher point equal. The JAX tools read orbax checkpoints written on a
  TPU, so here they restore them onto the CPU through a template
  (``tools/grasp_cnn_from_orbax.restore_on_cpu``; ``jax_tool``).
* No new tool pulls JAX, Flax, orbax or the JAX package into a process.
"""

import contextlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import eval_system_accuracy_torch as esa_t  # noqa: E402
from tools import fuzz_parity_torch as fuzz_t  # noqa: E402
from tools import parity_report_torch as parity_t  # noqa: E402
from tools._torch_eval import message_match  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: F401,E402

NEW_TOOLS = ("tools._torch_eval", "tools.parity_report_torch",
             "tools.fuzz_parity_torch", "tools.eval_system_accuracy_torch",
             "tools.eval_vla_system_torch",
             "tools.train_reference_model_torch",
             "tools.make_training_corpus_torch",
             "tools.train_best_config_torch", "tools.run_cnn_sweep_torch",
             "tools.train_vla_sweep_torch", "tools.render_sample_torch",
             "tools.angle_quantifier_shell_torch",
             "examples.run_spatial_demo_torch")
LOGIT_TOL = 1e-5


@contextlib.contextmanager
def jax_tool(module: str, argv):
    """A JAX tool's module with ``sys.argv`` set to ``argv`` and its
    orbax checkpoints restored onto the CPU."""
    import leafgrasp_tpu.training.checkpoint as jck
    from tools.grasp_cnn_from_orbax import restore_on_cpu
    orig = jck.load_checkpoint

    def load(path, template=None):
        # restore_on_cpu builds the template and calls back with it
        return orig(path, template) if template is not None \
            else restore_on_cpu(path)

    saved = sys.argv
    jck.load_checkpoint, sys.argv = load, ["tool", *argv]
    try:
        yield importlib.import_module(module)
    finally:
        jck.load_checkpoint, sys.argv = orig, saved


# ---- the converted checkpoints ----------------------------------------------------

@pytest.mark.parametrize("name", ["grasp_cnn", "grasp_cnn_hard"])
def test_converted_checkpoints_give_orbax_logits(name):
    from leafgrasp_tpu.models.grasp_cnn import GraspPointCNN as JCNN
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    from tools.grasp_cnn_from_orbax import (model_config_from_params,
                                            restore_on_cpu)
    restored = restore_on_cpu(os.path.join(ROOT, "artifacts", name,
                                           "best_model"))
    cfg = model_config_from_params(restored["params"])
    from leafgrasp_tpu.config import ModelConfig as JModelConfig
    jmodel = JCNN(JModelConfig(attention_type=cfg.attention_type,
                               encoder_filters=cfg.encoder_filters))
    x = np.random.default_rng(5).normal(size=(8, 32, 32, 9)) \
        .astype(np.float32)
    want = np.asarray(jmodel.apply(
        {"params": restored["params"],
         "batch_stats": restored["batch_stats"]}, x, train=False))
    pred = GraspQualityPredictor(cfg, device="cpu").load(
        os.path.join(ROOT, "artifacts", "torch", name, "best_model"))
    with torch.no_grad():
        got = pred.model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    for k in ("depth_mean", "depth_std", "score_mean", "score_std"):
        np.testing.assert_array_equal(pred.norm_stats[k],
                                      np.asarray(restored["norm_stats"][k]))


# ---- parity and the fuzzer --------------------------------------------------------

def test_parity_tool_gives_the_committed_golden_rows(tmp_path):
    out = parity_t.main(["--device", "cpu", "--seeds", "0,28,30",
                         "--out", str(tmp_path / "p.json")])
    assert out["mismatches"] == 0
    assert out["scenes"] == 3 and out["degenerate_scenes"] == 1
    assert out["leaf_equal"] == out["uv_equal"] == 3
    assert out["message_equal"] == out["degenerate_equal"] == 3
    assert out["oracle_uv_rows"] == out["oracle_uv_equal"] == 2
    with open(tmp_path / "p.json") as f:
        assert json.load(f)["rows"][0]["ours_uv"] == [194, 163]


def test_parity_tool_reports_a_differing_row(tmp_path):
    with open(os.path.join(ROOT, "PARITY.json")) as f:
        record = json.load(f)
    row = next(r for r in record["rows"] if r["seed"] == 0)
    row["ours_uv"] = [row["ours_uv"][0] + 1, row["ours_uv"][1]]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(record))
    out = parity_t.main(["--device", "cpu", "--seeds", "0", "--check",
                         str(bad), "--out", str(tmp_path / "p.json")])
    assert out["mismatches"] == 1 and out["uv_equal"] == 0


def test_fuzz_cases_give_jax_and_oracle_answers(tmp_path):
    from tests import reference_impl as ref
    from tests.test_geometry import _ref_candidates
    from leafgrasp_tpu.config import (FrameConfig, LeafSelectionConfig,
                                      PipelineConfig)
    from leafgrasp_tpu.io.scenes import make_leaf_scene
    from leafgrasp_tpu.pipeline.frame import make_frame_fn
    from leafgrasp_tpu.pipeline.ingest import format_result_message
    out = fuzz_t.main(["--device", "cpu", "--n", "3", "--h", "270",
                       "--w", "360", "--out", str(tmp_path / "f.json")])
    assert out["mismatch_count"] == 0 and not out["stats_compared"]
    with open(tmp_path / "f.json") as f:
        rows = json.load(f)["rows"]
    assert len(rows) == 3
    fn = make_frame_fn(PipelineConfig(
        frame=FrameConfig(height=270, width=360, max_leaves=12),
        leaf=LeafSelectionConfig(min_leaf_area=1500)), with_cnn=False)
    live = 0
    for row in rows:
        mask, depth = make_leaf_scene(270, 360, num_leaves=row["n_leaves"],
                                      seed=row["scene_seed"],
                                      margin=row["margin"])
        cam = [np.float32(row[k]) for k in ("cx", "cy", "f")]
        res = fn(mask, depth, *cam)
        assert row["found"] == bool(res.found)
        assert row["degenerate"] == bool(res.degenerate)
        assert row["leaf"] == int(res.leaf_id)
        assert row["uv"] == [int(v) for v in np.asarray(res.grasp_uv)]
        assert message_match(format_result_message(
            np.asarray(res.grasp_uv), np.asarray(res.grasp_xyz),
            np.asarray(res.pre_grasp_xyz)), row["message"])
        leaf, _ = ref.select_leaf_reference(mask, depth, row["cx"],
                                            row["cy"], row["f"],
                                            min_area=1500, mode="exact")
        assert leaf == row["leaf"]
        if row["degenerate"]:
            continue
        o = ref.grasp_scores_reference(mask == leaf, mask > 0, depth,
                                       row["cx"], row["cy"], row["f"],
                                       mode="exact")
        cands = _ref_candidates(o["traditional_score"], o["valid_region"],
                                20, 10)
        assert list(cands[0]) == row["uv"]
        live += 1
    assert live >= 1


def test_fuzz_draws_are_the_jax_fuzzers():
    """tools/fuzz_parity.py:66-75's draws at 540 x 720, in its order."""
    rng = np.random.default_rng(1000)
    for case in fuzz_t.draw_cases(5, 540, 720, 1000):
        assert case["scene_seed"] == int(rng.integers(0, 100000))
        assert case["n_leaves"] == int(rng.integers(3, 11))
        assert case["margin"] == int(rng.integers(54, 189 + 1))
        assert case["cx"] == float(360 + rng.uniform(-30, 30))
        assert case["cy"] == float(270 + rng.uniform(-30, 30))
        assert case["f"] == float(rng.uniform(600, 1800))


# ---- the system evaluations -------------------------------------------------------

@pytest.mark.parametrize("hard", [False, True], ids=["plain", "hard"])
def test_system_accuracy_gives_the_jax_tools_rows(tmp_path, hard):
    argv = ["--scenes", "3", "--height", "270", "--width", "360"] \
        + (["--hard"] if hard else [])
    with jax_tool("tools.eval_system_accuracy",
                  argv + ["--out", str(tmp_path / "jax.json")]) as tool:
        tool.main()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    got = esa_t.main(argv + ["--device", "cpu", "--check",
                             str(tmp_path / "jax.json"), "--out",
                             str(tmp_path / "torch.json")])
    assert got["mismatches"] == []
    assert got["scenes"] == want["scenes"] == got["rows_equal"] >= 1
    for key in ("leaf_agreement", "px_shift_mean", "cv_to_teacher_px_mean",
                "ml_to_teacher_px_mean"):
        assert got[key] == want[key], key


def test_system_accuracy_raises_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        esa_t.main(["--device", "cpu", "--scenes", "1", "--height", "270",
                    "--width", "360", "--ckpt", str(tmp_path / "none"),
                    "--out", str(tmp_path / "x.json")])
    out = esa_t.main(["--device", "cpu", "--scenes", "1", "--height",
                      "270", "--width", "360", "--random-init", "--out",
                      str(tmp_path / "x.json")])
    assert out["cnn_source"] == "random-init"


# ---- no JAX in the tools -----------------------------------------------------------

def test_new_tools_pull_in_no_jax(tmp_path):
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {NEW_TOOLS!r}:\n"
        "    importlib.import_module(m)\n"
        "from tools import parity_report_torch as p\n"
        "out = p.main(['--device', 'cpu', '--seeds', '0', '--out', "
        f"{str(tmp_path / 'p.json')!r}])\n"
        "assert out['mismatches'] == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'leafgrasp_tpu'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout[-2000:]

