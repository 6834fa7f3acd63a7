"""Hyperparameter sweep registry + file-backed experiment tracking,
PyTorch port of leafgrasp_tpu/training/experiments.py.

Rebuild of the reference's MLflow layer (train_model_mlflow.py:161-242,
mlflow_experiment_configs.py:12-367): 64 generated configurations over
{lr, batch size, weight decay, pos_weight, confidence weight} x
4 attention types x 4 encoder architectures, per-epoch metric logging,
ranked summaries.  Tracking is a dependency-free JSONL file store with
the same record shape MLflow would hold (params / per-epoch metrics /
final metrics), so sweeps run hermetically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional

from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
from leafgrasp_tpu_torch.models.grasp_cnn import ARCHITECTURES

__all__ = ["ExperimentConfig", "generate_experiment_configs",
           "ExperimentTracker", "run_sweep"]

ATTENTION_TYPES = ("spatial", "channel", "hybrid", "none")
CONFIDENCE_WEIGHTS = (0.1, 0.2, 0.3, 0.4)   # CV/ML blend strategies
                                            # (mlflow_experiment_configs.py:57-82)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    attention_type: str
    architecture: str
    learning_rate: float
    batch_size: int
    weight_decay: float
    pos_weight: float
    confidence_weight: float

    def model_config(self) -> ModelConfig:
        return ModelConfig(attention_type=self.attention_type,
                           encoder_filters=ARCHITECTURES[self.architecture])

    def train_config(self, **overrides) -> TrainConfig:
        return TrainConfig(learning_rate=self.learning_rate,
                           batch_size=self.batch_size,
                           weight_decay=self.weight_decay,
                           pos_weight=self.pos_weight, **overrides)


def generate_experiment_configs() -> List[ExperimentConfig]:
    """64 configs: 4 attention x 4 architectures x 4 hyper bundles
    (matches the reference's sweep size, train_model_mlflow.py:161-220)."""
    hyper_bundles = [
        dict(learning_rate=5e-4, batch_size=16, weight_decay=0.01,
             pos_weight=2.0, confidence_weight=0.3),
        dict(learning_rate=1e-3, batch_size=16, weight_decay=0.01,
             pos_weight=1.5, confidence_weight=0.2),
        dict(learning_rate=5e-4, batch_size=32, weight_decay=0.005,
             pos_weight=2.0, confidence_weight=0.4),
        dict(learning_rate=1e-4, batch_size=8, weight_decay=0.02,
             pos_weight=2.5, confidence_weight=0.1),
    ]
    configs = []
    for attention in ATTENTION_TYPES:
        for arch in ARCHITECTURES:
            for i, bundle in enumerate(hyper_bundles):
                configs.append(ExperimentConfig(
                    name=f"{attention}_{arch}_h{i}",
                    attention_type=attention, architecture=arch, **bundle))
    assert len(configs) == 64
    return configs


class ExperimentTracker:
    """Append-only JSONL store: one record per run, per-epoch metrics
    inline. Layout mirrors what the reference logs to MLflow
    (train_model_mlflow.py:419-430,455)."""

    def __init__(self, root: str, experiment: str = "leafgrasp-tpu"):
        self.root = os.path.expanduser(root)
        self.experiment = experiment
        os.makedirs(self.root, exist_ok=True)
        self.path = os.path.join(self.root, f"{experiment}.jsonl")

    def log_run(self, name: str, params: Dict, epochs: List[Dict],
                final: Dict) -> Dict:
        record = {
            "run": name,
            "experiment": self.experiment,
            "timestamp": time.time(),
            "params": params,
            "epochs": epochs,
            "final": final,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return record

    def runs(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def top_k(self, k: int = 10, metric: str = "f1_score") -> List[Dict]:
        """Rank by the headline metric; break exact F1 ties (identical
        confusion matrices are common on a ~250-sample val split) by the
        threshold-calibrated F1, then by best val loss (lower = better),
        so the ranking is a strict total order wherever the underlying
        runs differ at all."""
        runs = self.runs()

        def _key(r):
            final = r["final"]
            cal = final.get("calibrated") or {}
            return (final.get(metric, -1),
                    cal.get(metric, final.get(metric, -1)),
                    -final.get("best_val_loss", float("inf")))

        runs.sort(key=_key, reverse=True)
        return runs[:k]

    def write_summary(self, k: int = 10) -> str:
        path = os.path.join(self.root, f"{self.experiment}_summary.json")
        with open(path, "w") as f:
            json.dump({"top": [
                {"run": r["run"], "final": r["final"],
                 "params": r["params"]} for r in self.top_k(k)
            ]}, f, indent=2)
        return path


def run_sweep(dataset, tracker: ExperimentTracker,
              configs: Optional[Iterable[ExperimentConfig]] = None,
              epochs: int = 20, limit: Optional[int] = None, device=None):
    """Train every config on ``device`` (None means CUDA), log per-epoch
    + final metrics, rank by F1."""
    from leafgrasp_tpu_torch.training.train import Trainer

    configs = list(configs or generate_experiment_configs())
    if limit:
        configs = configs[:limit]
    results = []
    for cfg in configs:
        trainer = Trainer(model_cfg=cfg.model_config(),
                          cfg=cfg.train_config(), device=device)
        res = trainer.fit(dataset, epochs=epochs)
        epochs_log = [
            {"epoch": i, "train_loss": tl, "val_loss": vl,
             "f1_score": m["f1_score"]}
            for i, (tl, vl, m) in enumerate(zip(
                res.history["train_loss"], res.history["val_loss"],
                res.history["metrics"]))]
        final = dict(res.metrics)
        final["best_val_loss"] = res.best_val_loss
        tracker.log_run(cfg.name, dataclasses.asdict(cfg), epochs_log,
                        final)
        results.append((cfg, res))
    tracker.write_summary()
    return results
