"""VLA fine-tuning experiment sweep: the port of
leafgrasp_tpu/vla/experiments.py.

The four named configurations of the reference's production sweep
(baseline_5e5 / higher_lr_1e4 / larger_rank_16 / optimized_config), each
a real LoRA training run of the TinyVLA followed by a top-1 / Spearman
evaluation. It writes the JAX sweep's files with its keys:
``pretrained_base.npz`` (with ``pretrain_epochs > 0``),
``<name>/adapter.npz`` and its ``.adapter_config.json``,
``<name>/training_history.json`` and ``sweep_summary.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from leafgrasp_tpu_torch.vla.convert import torch_to_flax_tiny_vla
from leafgrasp_tpu_torch.vla.lm import VLAModelConfig
from leafgrasp_tpu_torch.vla.lora import graft_base_params
from leafgrasp_tpu_torch.vla.trainer import (VLATrainer,
                                             make_synthetic_vla_dataset,
                                             save_npz)

__all__ = ["VLAExperiment", "PRODUCTION_EXPERIMENTS", "run_vla_sweep"]


@dataclasses.dataclass(frozen=True)
class VLAExperiment:
    name: str
    learning_rate: float
    lora_rank: int
    lora_alpha: float
    lora_dropout: float
    epochs: int = 3


PRODUCTION_EXPERIMENTS = (
    VLAExperiment("baseline_5e5", 5e-5, 8, 32.0, 0.1),
    VLAExperiment("higher_lr_1e4", 1e-4, 8, 32.0, 0.1),
    VLAExperiment("larger_rank_16", 5e-5, 16, 32.0, 0.1),
    VLAExperiment("optimized_config", 8e-5, 8, 16.0, 0.05),
)


def run_vla_sweep(out_dir: str,
                  experiments=PRODUCTION_EXPERIMENTS,
                  num_train: int = 24, num_eval: int = 8,
                  model_cfg: Optional[VLAModelConfig] = None,
                  seed: int = 0, log_fn=None,
                  pretrain_epochs: int = 0, device=None) -> List[Dict]:
    """Train and evaluate each experiment; write its files.

    model_cfg: the base LM's size (LoRA fields are set per experiment).
    pretrain_epochs > 0 first pretrains ONE shared base (every parameter)
    on the training corpus, saves it, and grafts it into every LoRA
    experiment. ``device=None`` means CUDA."""
    out_dir = os.path.expanduser(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    base = model_cfg or VLAModelConfig()

    train_set = make_synthetic_vla_dataset(num_train, seed=seed)
    eval_set = make_synthetic_vla_dataset(num_eval, seed=seed + 1)

    pretrained = None
    if pretrain_epochs > 0:
        base_trainer = VLATrainer(
            cfg=dataclasses.replace(base, lora_rank=0), seed=seed,
            device=device)
        base_trainer.pretrain(train_set, epochs=pretrain_epochs,
                              log_fn=log_fn)
        pretrained = base_trainer.model.state_dict()
        # the adapters are deltas ON this base: ship it beside them
        save_npz(os.path.join(out_dir, "pretrained_base.npz"),
                 torch_to_flax_tiny_vla(pretrained))

    results = []
    for exp in experiments:
        cfg = dataclasses.replace(base, lora_rank=exp.lora_rank,
                                  lora_alpha=exp.lora_alpha,
                                  lora_dropout=exp.lora_dropout)
        trainer = VLATrainer(cfg=cfg, learning_rate=exp.learning_rate,
                             seed=seed, device=device)
        if pretrained is not None:
            trainer.model.load_state_dict(graft_base_params(
                trainer.model.state_dict(), pretrained))
        fit = trainer.fine_tune(train_set, epochs=exp.epochs,
                                log_fn=log_fn)
        metrics = trainer.evaluate(eval_set)

        exp_dir = os.path.join(out_dir, exp.name)
        os.makedirs(exp_dir, exist_ok=True)
        trainer.save_adapter(os.path.join(exp_dir, "adapter.npz"))
        history = {
            "experiment": exp.name,
            "pretrain_epochs": pretrain_epochs,
            "params": dataclasses.asdict(exp),
            "loss_history": fit["loss_history"],
            "final_loss": fit["final_loss"],
            "top1_accuracy": metrics["top1_accuracy"],
            "spearman": metrics["spearman"],
        }
        with open(os.path.join(exp_dir, "training_history.json"),
                  "w") as f:
            json.dump(history, f, indent=2)
        results.append(history)

    with open(os.path.join(out_dir, "sweep_summary.json"), "w") as f:
        json.dump(sorted(results, key=lambda r: -r["top1_accuracy"]),
                  f, indent=2)
    return results
