"""The MoE rerank cell (``vla.moe.anyres.bf16``) at a tiny size on the
CPU: it resolves, a sound run is correct against
``reference/llava_moe_ref.py``, each of its faults (the correction bias
left out of the expert choice, the latent cached before
``kv_a_layernorm``) makes ``correct`` false, and the work functions
count the tiny model's active products as a hand count does."""

import json

import pytest
import torch

from benchmark.core import main, spec, work, work_moe
from benchmark.tests.tiny import TINY_FRAME

TINY_MOE = {"vis_hidden": 16, "vis_intermediate": 32, "vis_layers": 2,
            "vis_heads": 2, "image_size": 28, "patch_size": 14,
            "vocab_size": 128, "hidden": 64, "intermediate": 96,
            "layers": 3, "heads": 4, "kv_heads": 4,
            "image_token_index": 100,
            "image_grid_pinpoints": [[28, 56], [56, 28], [56, 56]],
            "kv_lora_rank": 32, "qk_nope_head_dim": 32,
            "qk_rope_head_dim": 16, "v_head_dim": 32, "n_routed_experts": 8,
            "num_experts_per_tok": 2, "n_shared_experts": 1,
            "moe_intermediate_size": 24}
TINY_VLA_MOE = dict(TINY_FRAME, cycle_frames=4, check_frames=2,
                    check_reranks=2, leaves=[3, 6], llava=TINY_MOE)
NAME = "vla.moe.anyres.bf16"


def _run(cell=None, seed=7, trace=False):
    torch.set_num_threads(2)
    cell = cell or spec.resolve(NAME)
    run = main.run_cell(cell, seed, 0.5, trace, torch.device("cpu"), 0.0,
                        json.loads(json.dumps(TINY_VLA_MOE)))
    limits = run.check()
    return run, main.result_line(cell, run, limits, trace,
                                 {"platform": "cpu", "kind": "cpu",
                                  "count": 1, "memory_peak_bytes": 0})


def test_cells_resolve():
    moe = spec.resolve(NAME)
    assert moe.config["model"] == "llava_moe_rerank"
    assert moe.config["n_routed_experts"] == 64 and moe.chips == 1
    assert {m["name"] for m in moe.end_to_end} == {
        "frames_per_s", "frame_p50_ms", "setup_s"}
    names = {m["name"] for m in moe.per_layer}
    assert {"kernels.moe_experts_roofline", "vla.moe_experts_ms",
            "vla.moe_load_max_over_mean", "vla.decode_graph_share",
            "kernels.prefill_attention_roofline", "mfu.serve"} <= names
    assert "token_gap_row_mean" in moe.limits
    lora = spec.resolve("lora.train.t642")
    assert lora.traffic["loop"] == "train_lora"
    assert lora.config["name"] == "llava-v1.6-mistral-7b"
    assert {m["name"] for m in lora.end_to_end} == {"train_device_ms",
                                                    "setup_s"}
    assert set(lora.limits) == {"grad1_rel", "change_med_rel"}


def test_published_keys_are_the_catalogs():
    """The configuration's top-level keys as Moonlight publishes them
    (nothing reduced), served as the deepseek_v3 decoder."""
    from benchmark.models import llava_moe_rerank as moe
    cell = spec.resolve(NAME)
    c = moe.model_config(cell.config)
    assert (c.hidden, c.layers, c.heads, c.kv_lora_rank, c.v_head_dim,
            c.n_routed_experts, c.num_experts_per_tok,
            c.moe_intermediate_size, c.vocab_size) == (
        2048, 27, 16, 512, 128, 64, 6, 1408, 163840)
    with pytest.raises(ValueError):
        moe.model_config(dict(cell.config, q_lora_rank=1536))


@pytest.mark.parametrize("fault", ["bias", "latent"])
def test_moe_faults_fail_against_the_reference(fault):
    from benchmark.controls.vla_moe_control import fault as broken
    # at this size the balanced biases are a few hundredths, and on some
    # draws (seed 7's) leaving them out moves no served token, which no
    # judge of the tokens can see; seed 8's draw is one where it does
    sound = _run(seed=8)[1]
    assert sound["correct"] is True
    # the tiny model's logits spread over a few tenths, not the 16B's
    # units: its limit is held at the sound run's reading
    cell = spec.resolve(NAME)
    cell.limits = dict(cell.limits, token_gap_row_mean=max(
        sound["limits"]["token_gap_row_mean"]["value"], 1e-6))
    with broken(fault):
        line = _run(cell, seed=8)[1]
    assert line["correct"] is False
    assert line["limits"]["token_gap_row_mean"]["value"] > \
        line["limits"]["token_gap_row_mean"]["limit"]


def test_router_set_up_runs_no_program_code(monkeypatch):
    """The routers are set from the plain reference's pass alone: with
    the program's decoder unable to run, the rerank still builds, and
    its gates and biases differ from the draw."""
    from benchmark.models import llava_moe_rerank as moe
    from leafgrasp_tpu_torch.vla import llava_torch, moe as pmoe

    def broken(*args, **kwargs):
        raise AssertionError("program code ran at set-up")
    monkeypatch.setattr(llava_torch.LlavaTorch, "forward", broken)
    monkeypatch.setattr(pmoe.MoE, "forward", broken)
    cell = spec.resolve(NAME)
    torch.set_num_threads(2)
    over = json.loads(json.dumps(TINY_VLA_MOE))
    traffic = dict(cell.traffic, **over)
    rr = moe.Rerank(cell.config, 7, torch.device("cpu"), over, traffic)
    drawn = moe.draw_state(rr.cfg, 7, torch.device("cpu"),
                           cell.config["kv_a_layernorm_gain_spread"])
    bias = "layers.1.mlp.gate.e_score_correction_bias"
    assert not torch.equal(rr.state[bias], drawn[bias])
    assert not torch.equal(rr.state["layers.1.mlp.gate.weight"],
                           drawn["layers.1.mlp.gate.weight"])
    assert torch.equal(rr.state["layers.1.mlp.experts.up_proj"],
                       drawn["layers.1.mlp.experts.up_proj"])


def test_replayed_decode_expert_calls_counted_from_shapes():
    """A rerank whose decode replayed a graph, which no wrapper sees: its
    steps' routed pairs counted from the shapes, each call's experts
    read as one token's k; the kernel's wrapper put back afterwards."""
    import numpy as np
    from benchmark.models import llava_moe_rerank as moe
    from leafgrasp_tpu_torch.kernels import moe_experts as me
    cell = spec.resolve(NAME)
    torch.set_num_threads(2)
    over = json.loads(json.dumps(TINY_VLA_MOE))
    rr = moe.Rerank(cell.config, 7, torch.device("cpu"), over,
                    dict(cell.traffic, **over))
    c, orig = rr.cfg, me.moe_experts
    counts: dict = {}
    rr.count_work(counts)
    assert me.moe_experts is not orig
    rows = [[1, 2, 3]] * 5
    rec = {"rows": rows, "image": np.zeros((56, 56, 3), np.uint8),
           "last": {"n_image_tokens": 4, "tokens": [[5] * 10] * 5,
                    "decode_graph": "replayed", "moe_load": [[1.0, 1.0]]}}
    rr._count(rec)
    rr.stop_counting()
    assert me.moe_experts is orig
    n_moe, k = c.layers - c.first_k_dense_replace, c.num_experts_per_tok
    pairs = 9 * n_moe * 5 * k
    assert counts["moe_pairs.few"] == pairs
    assert counts["moe_bytes.few"] == work_moe.expert_bytes(
        c, pairs, 9 * n_moe * k)
    assert counts["moe_pairs.many"] == 0.0


def test_traced_run_reports_the_moe_load():
    run, line = _run(trace=True)
    assert line["metrics"]["vla.moe_load_max_over_mean"]["value"] >= 1.0
    assert run.work["traced_reranks"] >= 1


def test_work_counts_the_tiny_models_active_products():
    from benchmark.models import llava_moe_rerank as moe
    c = moe.model_config(spec.resolve(NAME).config,
                         {"llava": TINY_MOE})
    h, hh = 64, 4
    attn = h * hh * 48 + h * 48 + 32 * hh * 64 + hh * 32 * h
    dense = 3 * h * 96
    expert_layer = h * 8 + 3 * h * 24 * (2 + 1)
    assert work_moe.decoder_token_flop(c) == 2.0 * (3 * attn + dense
                                                    + 2 * expert_layer)
    rows = [[1, 2, 3], [1, 2, 4]]
    assert work.shared_prefix_pairs(rows) == 1 + 2 + 3 + 3
    assert work_moe.prefill_attention_flop(c, rows) == \
        2.0 * 9 * hh * (48 + 32) * 3
    assert work_moe.prefill_attention_bytes(c, rows) == \
        2.0 * 4 * hh * 2 * (48 + 32) * 3
    assert work_moe.expert_flop(c, 10) == 2.0 * 3 * h * 24 * 10
    assert work_moe.expert_bytes(c, 10, 3) == \
        3 * (3.0 * h * 24 * 2) + 2.0 * 5 * h * 2
