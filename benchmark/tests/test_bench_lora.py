"""The LoRA training cell (``lora.train.t642``) at a tiny size on the CPU,
in float32 (the configuration's bf16 moves a tiny model's gradients past
the limits that the 7B's readings set): a sound run is correct, each of
its faults (the adapters' state left unchanged, half the batch) makes
``correct`` false, and its control (every matrix of the reference in
float8 e4m3) reads far above the program."""

import json

import pytest
import torch

from benchmark.core import main, spec
from benchmark.tests.tiny import TINY_LLAVA

NAME = "lora.train.t642"
TINY_LORA = {"llava": dict(TINY_LLAVA, dtype="float32"), "pool": 3,
             "text_tokens": 8, "answer_tokens": 3, "image_px": 28,
             "warmup_steps": 1, "trace_steps": 2}


def _run(seed=7, trace=False):
    torch.set_num_threads(2)
    cell = spec.resolve(NAME)
    run = main.run_cell(cell, seed, 0.3, trace, torch.device("cpu"), 0.0,
                        json.loads(json.dumps(TINY_LORA)))
    limits = run.check()
    return run, main.result_line(cell, run, limits, trace,
                                 {"platform": "cpu", "kind": "cpu",
                                  "count": 1, "memory_peak_bytes": 0})


def test_sound_lora_run_is_correct():
    run, line = _run(trace=True)
    assert line["correct"] is True, line["limits"]
    assert run.steps >= 1 and run.kind == "train"
    assert "train.step_ms" in line["metrics"]


def test_lora_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    line = _run()[1]
    assert line["correct"] is False
    assert line["limits"]["grad1_rel"]["value"] == pytest.approx(1.0)
    assert line["limits"]["change_med_rel"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["lr0", "update_to_a_copy"])
def test_lora_moments_filled_adapters_unchanged(monkeypatch, fault):
    """AdamW fills its moments, so the step's gradients read right, but
    the adapters do not move: a learning rate of 0, or the update
    written to a copy (the adapters put back after the step). The
    change over the step reads 1."""
    from leafgrasp_tpu_torch.vla import trainer
    if fault == "lr0":
        orig = trainer.make_adamw
        monkeypatch.setattr(trainer, "make_adamw",
                            lambda params, lr: orig(params, 0.0))
    else:
        orig = torch.optim.AdamW.step

        def restored(self, closure=None):
            kept = [p.detach().clone() for g in self.param_groups
                    for p in g["params"]]
            orig(self, closure)
            with torch.no_grad():
                for p, k in zip((p for g in self.param_groups
                                 for p in g["params"]), kept):
                    p.copy_(k)
        monkeypatch.setattr(torch.optim.AdamW, "step", restored)
    line = _run()[1]
    lim = line["limits"]
    assert line["correct"] is False
    assert lim["grad1_rel"]["value"] <= lim["grad1_rel"]["limit"]
    assert lim["change_med_rel"]["value"] == pytest.approx(1.0)


def test_lora_half_batch(monkeypatch):
    from leafgrasp_tpu_torch.vla.llava_trainer import LlavaLoRATrainer
    orig = LlavaLoRATrainer.loss

    def half(self, toks, lmask, imgs):
        n = toks.shape[0] // 2
        return orig(self, toks[:n], lmask[:n], imgs[:n])
    monkeypatch.setattr(LlavaLoRATrainer, "loss", half)
    line = _run()[1]
    assert line["correct"] is False
    assert line["limits"]["grad1_rel"]["value"] > \
        line["limits"]["grad1_rel"]["limit"]


def test_lora_control_and_faults_read_apart_from_the_program():
    """The readings' script at the tiny size: the program within the
    limits, half the batch and the unchanged state past them. The fp8
    control moves the tiny model's gradients less than the 7B's (0.07
    here, 0.56 to 0.67 at the cell's size, PERF.md): here it reads far
    above the program, and past the limits only on the card."""
    from benchmark.controls import lora_control
    cell = spec.resolve(NAME)
    r = lora_control.readings(cell, 3, torch.device("cpu"),
                              json.loads(json.dumps(TINY_LORA)))
    lim = cell.limits
    assert r["program_grad1_rel"] <= lim["grad1_rel"]
    assert r["control_fp8_grad1_rel"] > 100 * r["program_grad1_rel"]
    assert r["control_fp8_loss1_rel"] > 100 * r["program_loss1_rel"]
    assert r["fault_half_batch_loss1_rel"] > 100 * r["program_loss1_rel"]
    assert r["fault_half_batch_grad1_rel"] > lim["grad1_rel"]
    assert r["program_change_med_rel"] <= lim["change_med_rel"]
    assert r["fault_state_unchanged_grad1_rel"] == pytest.approx(1.0)
    assert r["fault_state_unchanged_change_med_rel"] == pytest.approx(1.0)
