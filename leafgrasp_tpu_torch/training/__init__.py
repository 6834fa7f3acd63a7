"""Self-supervised training stack of the port (counterpart of
leafgrasp_tpu/training): collector, trainer, sweeps, checkpoints,
verification, dashboards."""

from leafgrasp_tpu_torch.training.train import (Trainer, TrainResult,
                                                NormStats,
                                                normalize_dataset,
                                                bce_with_logits,
                                                analyze_predictions)
from leafgrasp_tpu_torch.training.data_collector import GraspDataCollector
from leafgrasp_tpu_torch.training.teacher import (teacher_select,
                                                  collect_from_frames)
from leafgrasp_tpu_torch.training.experiments import (
    ExperimentTracker, generate_experiment_configs, run_sweep)
from leafgrasp_tpu_torch.training.checkpoint import (save_checkpoint,
                                                     load_checkpoint)
from leafgrasp_tpu_torch.training.verify_data import verify_dataset
from leafgrasp_tpu_torch.training.plots import plot_metrics

__all__ = ["Trainer", "TrainResult", "NormStats", "normalize_dataset",
           "bce_with_logits", "analyze_predictions", "GraspDataCollector",
           "teacher_select", "collect_from_frames", "ExperimentTracker",
           "generate_experiment_configs", "run_sweep", "save_checkpoint",
           "load_checkpoint", "verify_dataset", "plot_metrics"]
