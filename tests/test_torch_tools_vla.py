"""The port's VLA system evaluation (``tools/eval_vla_system_torch.py``)
against the JAX tool (``tools/eval_vla_system.py``) run here into
``tmp_path``, on the CPU at 540 x 720 (at 270 x 360 the hard scenes'
120-pixel margin leaves no live frame): every leaf, pixel, strategy and
VLA choice equal, the VLA confidence within 1e-3.

The JAX tool's scorer is rebuilt with the pretrained base in its frozen
slots (``graft_base_params``): the tool's own ``attach_lora`` leaves them
at a fresh initialization (ROADMAP C, standing), which the port does not
copy, so the committed artifacts/system_accuracy_vla.json holds the
answers of a scorer whose decoder projections were never trained.

Run as a script, the file writes the reference record that
``chip_smoke.py`` holds the card to (the JAX tool with the grafted
scorer, on the CPU, at the committed record's 26 scenes of 1080 x 1440):

    JAX_PLATFORMS=cpu python tests/test_torch_tools_vla.py \\
        artifacts/torch/reference/system_accuracy_vla.json
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tools import eval_vla_system_torch as evs_t  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: F401,E402
from tests.test_torch_tools_eval import jax_tool  # noqa: E402


def grafted_arch_scorer(vla_dir, max_new_tokens=6):
    """The JAX tool's LLaVA-arch scorer with the pretrained base in the
    frozen slots (``graft_base_params``) and the adapter over it."""
    import flax.traverse_util as tu
    from leafgrasp_tpu.vla.lora import graft_base_params, merge_lora_params
    from leafgrasp_tpu.vla.llava_jax import LlavaJax, LlavaJaxConfig
    from leafgrasp_tpu.vla.llava_runtime import LlavaJaxScorer
    from leafgrasp_tpu.vla.lm import ByteTokenizer
    from tools.eval_vla_system import _ARCH

    def tree(name):
        with np.load(os.path.join(vla_dir, name)) as f:
            return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in f.items()})

    model = LlavaJax(LlavaJaxConfig(**_ARCH, lora_rank=8, lora_alpha=16.0))
    fresh = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32),
                       pixel_values=jnp.zeros((1, 28, 28, 3)))
    params = merge_lora_params(
        graft_base_params(fresh["params"], tree("llava_arch_base.npz")),
        tree("llava_arch_adapter.npz"))
    return LlavaJaxScorer(model, {"params": params}, ByteTokenizer(),
                          max_new_tokens=max_new_tokens)


def jax_vla_record(out, scenes, height, width) -> dict:
    """JAX tools/eval_vla_system.py with the grafted scorer; its JSON,
    with the ``prompts`` the port's tool keeps (what each reranked
    frame's prompts print of its candidates), written back to ``out``."""
    import leafgrasp_tpu.io.scenes as jscenes
    import leafgrasp_tpu.vla.hybrid as jhybrid
    argv = ["--scenes", str(scenes), "--height", str(height), "--width",
            str(width), "--out", str(out)]
    prompts, seed = {}, [None]
    make_scene, selector = jscenes.make_hard_leaf_scene, \
        jhybrid.HybridGraspSelector

    def scene(*a, **kw):
        seed[0] = kw["seed"]
        return make_scene(*a, **kw)

    class Recording(selector):
        def select_grasp_point(self, image, candidates, *a, **kw):
            prompts[str(seed[0])] = evs_t.prompt_inputs(candidates)
            return super().select_grasp_point(image, candidates, *a, **kw)

    with jax_tool("tools.eval_vla_system", argv) as tool:
        saved = tool.load_arch_scorer
        tool.load_arch_scorer = grafted_arch_scorer
        jscenes.make_hard_leaf_scene = scene
        jhybrid.HybridGraspSelector = Recording
        try:
            tool.main()
        finally:
            tool.load_arch_scorer = saved
            jscenes.make_hard_leaf_scene = make_scene
            jhybrid.HybridGraspSelector = selector
    with open(out) as f:
        record = json.load(f)
    record["prompts"] = prompts
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    return record


def test_vla_eval_gives_the_jax_tools_rows(tmp_path):
    # at 270 x 360 the hard scenes' 120-pixel margin leaves no live frame
    want = jax_vla_record(tmp_path / "jax.json", 3, 540, 720)
    got = evs_t.main(["--device", "cpu", "--scenes", "3", "--height",
                      "540", "--width", "720", "--check",
                      str(tmp_path / "jax.json"), "--out",
                      str(tmp_path / "torch.json")])
    assert got["mismatches"] == []
    assert got["scenes"] == want["scenes"] == got["rows_equal"] >= 2
    assert got["rows_vla_compared"] == got["scenes"]
    assert got["prompts_equal"] == got["prompts_compared"] >= 2
    assert got["strategy_distribution"] == want["strategy_distribution"]
    assert got["vla_fallback_frames"] == 0


def test_the_vla_records_agree_where_they_should():
    """The records under artifacts/torch/reference: the port's CPU answers
    at 1080 x 1440 against today's grafted JAX tool's, by the tool's own
    rule (geometric columns on every row, VLA columns where the prompts
    agree), and the JAX record's geometric columns against the committed
    artifacts/system_accuracy_vla.json on the scenes both hold."""
    from tools._torch_eval import compare_rows
    ref = os.path.join(ROOT, "artifacts", "torch", "reference")
    with open(os.path.join(ref, "system_accuracy_vla_port_cpu.json")) as f:
        port = json.load(f)
    with open(os.path.join(ref, "system_accuracy_vla.json")) as f:
        jax_rec = json.load(f)
    with open(os.path.join(ROOT, "artifacts",
                           "system_accuracy_vla.json")) as f:
        committed = json.load(f)
    out = evs_t.check_rows(port["rows"], port["prompts"], jax_rec,
                           range(100, 126))
    assert out["mismatches"] == [] and out["rows_compared"] == 23
    assert out["prompts_compared"] == 26 and out["prompts_equal"] >= 1
    common = {r["seed"] for r in jax_rec["rows"]} & {
        r["seed"] for r in committed["rows"]}
    assert len(common) == 21
    assert compare_rows(jax_rec["rows"], committed["rows"], common,
                        ("leaf_geo", "uv_geo")) == []


def test_centroids_round_once_where_jax_parts_in_the_last_bits():
    """Why the full-size VLA prompts part: on hard scene 102 at 1080 x
    1440 the port's leaf centroids are the exact means rounded once to
    f32 (the f32 sum of the float64 one, divided by the area), while
    JAX's f32 sums in XLA's order put some of them 1-2 ulps away."""
    import torch
    from leafgrasp_tpu.config import FrameConfig as JFrame
    from leafgrasp_tpu.config import LeafSelectionConfig as JLeaf
    from leafgrasp_tpu.geometry.leaf_scorer import select_optimal_leaf \
        as jselect
    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig)
    from leafgrasp_tpu_torch.geometry.leaf_scorer import \
        select_optimal_leaf
    from leafgrasp_tpu_torch.io.scenes import make_hard_leaf_scene
    cam = [np.float32(v) for v in (707.87, 494.07, 1750.68)]
    mask, depth = make_hard_leaf_scene(1080, 1440, num_leaves=8, seed=102,
                                       margin=120)
    ids = mask.astype(np.int32)
    got = select_optimal_leaf(
        torch.from_numpy(ids), torch.from_numpy(depth),
        *(torch.tensor(c) for c in cam), cfg=LeafSelectionConfig(
            min_leaf_area=10000), frame=FrameConfig(max_leaves=8))
    want = jax.jit(lambda m, d: jselect(
        m, d, *cam, cfg=JLeaf(min_leaf_area=10000),
        frame=JFrame(max_leaves=8)))(jnp.asarray(ids), jnp.asarray(depth))
    ulps = []
    for axis, name in ((1, "centroid_x"), (0, "centroid_y")):
        for leaf in range(1, 9):
            coords = np.nonzero(ids == leaf)[axis]
            exact = np.float32(coords.sum(dtype=np.float64)) \
                / np.float32(len(coords))
            port = getattr(got.stats, name)[leaf - 1].numpy()
            jx = np.asarray(getattr(want.stats, name))[leaf - 1]
            assert port == exact, (name, leaf)
            ulps.append(abs(int(jx.view(np.int32))
                            - int(np.float32(exact).view(np.int32))))
    assert 0 < max(ulps) <= 2 and sum(u > 0 for u in ulps) >= 2


def test_vla_check_holds_vla_columns_only_where_prompts_agree(tmp_path):
    """A record whose prompts differ in one scene: that scene's VLA
    columns are not held, its geometric ones are; the same record with
    a VLA column changed in an agreeing scene is a mismatch."""
    rows = [{"seed": 100, "leaf_geo": 1, "uv_geo": [5, 6], "leaf_vla": 2,
             "uv_vla": [7, 8], "strategy": "BALANCED", "vla_leaf": 2,
             "vla_confidence": 0.5},
            {"seed": 101, "leaf_geo": 3, "uv_geo": [1, 2], "leaf_vla": 3,
             "uv_vla": [1, 2], "strategy": "BALANCED", "vla_leaf": 3,
             "vla_confidence": 0.6}]
    def cand(leaf, x, g=0.1):
        return [{"leaf_id": leaf, "x": x, "y": 2.5, "geometric_score": g,
                 "clutter_score": 0.2, "distance_score": 0.3}]

    prompts = {"100": cand(1, 1.5), "101": cand(3, 4.0)}
    other = json.loads(json.dumps(rows))
    other[0].update(leaf_vla=1, uv_vla=[5, 6], vla_leaf=1,
                    vla_confidence=0.9, strategy="VLA_DOMINANT")
    # 1.5000001 prints otherwise; a score off in its fourth decimal not
    theirs = {"100": cand(1, 1.5000001), "101": cand(3, 4.0, g=0.10001)}
    out = evs_t.check_rows(rows, prompts,
                           {"rows": other, "prompts": theirs}, [100, 101])
    assert out["mismatches"] == []
    assert out["prompts_equal"] == 1 and out["rows_vla_compared"] == 1
    other[1]["strategy"] = "VLA_DOMINANT"
    other[0]["uv_geo"] = [5, 7]
    out = evs_t.check_rows(rows, prompts,
                           {"rows": other, "prompts": theirs}, [100, 101])
    assert {(m["seed"], m["field"]) for m in out["mismatches"]} == {
        (100, "uv_geo"), (101, "strategy")}
    out = evs_t.check_rows(rows, prompts, {"rows": rows[1:]}, [100, 101])
    assert out["mismatches"] == [{"seed": 100, "field": "row",
                                  "ours": True, "record": False}]


if __name__ == "__main__":
    out = sys.argv[1]
    jax.config.update("jax_platforms", "cpu")
    record = jax_vla_record(out, 26, 1080, 1440)
    record["made_by"] = (
        "tools/eval_vla_system.py on the CPU with the pretrained base "
        "grafted into the scorer's frozen slots (graft_base_params; "
        "tests/test_torch_tools_vla.py grafted_arch_scorer)")
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("rows", "prompts")}))
