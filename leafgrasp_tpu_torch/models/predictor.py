"""GraspQualityPredictor: thin eval facade over GraspPointCNN, PyTorch
port of leafgrasp_tpu/models/predictor.py (reference
ml_grasp_optimizer/model.py:130-162): concatenates patch channels and
returns a scalar quality score. Batched by construction.

Weights are a ``state_dict`` of the port's GraspPointCNN: seeded, given,
or loaded from a ``torch.save`` file, such as the port's training
checkpoint (``training/checkpoint.py``). A JAX (orbax) checkpoint goes
through ``tools/grasp_cnn_from_orbax.py`` first; the port never reads
orbax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from leafgrasp_tpu_torch.config import ModelConfig
from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN, init_random_
from leafgrasp_tpu_torch.utils.device import resolve_device

__all__ = ["GraspQualityPredictor"]


class GraspQualityPredictor:
    def __init__(self, cfg: ModelConfig = ModelConfig(), state_dict=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.norm_stats = None
        self.model = GraspPointCNN(cfg)
        if state_dict is None:
            init_random_(self.model, seed=seed)
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    def load(self, checkpoint_path: str):
        """Load a ``state_dict`` saved with ``torch.save``: the bare dict,
        or a dict holding it under ``"state_dict"``, as the port's
        training checkpoint does; that checkpoint's normalization stats
        become ``self.norm_stats`` (numpy arrays; the ``norm_stats`` of
        ``make_frame_fn``), else it is None."""
        restored = torch.load(checkpoint_path, map_location=self.device,
                              weights_only=True)
        self.norm_stats = None
        if "state_dict" in restored:
            if "norm_stats" in restored:
                self.norm_stats = {k: v.cpu().numpy() for k, v in
                                   restored["norm_stats"].items()}
            restored = restored["state_dict"]
        self.model.load_state_dict(restored)
        self.model.eval()
        return self

    @torch.no_grad()
    def _apply(self, feats) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(feats, np.float32),
                            device=self.device)
        return torch.sigmoid(self.model(x).reshape(-1))

    def predict(self, patch_data: Dict) -> float:
        """patch_data: depth_patch (P,P), mask_patch (P,P),
        score_patches (7,P,P) -> sigmoid score in [0,1]."""
        feats = np.concatenate([
            np.asarray(patch_data["depth_patch"],
                       np.float32)[None, :, :, None],
            np.asarray(patch_data["mask_patch"],
                       np.float32)[None, :, :, None],
            np.moveaxis(np.asarray(patch_data["score_patches"],
                                   np.float32), 0, -1)[None],
        ], axis=-1)
        return float(self._apply(feats)[0])

    def predict_batch(self, feats: np.ndarray) -> np.ndarray:
        """(N, P, P, 9) NHWC -> (N,) sigmoid scores."""
        return self._apply(feats).cpu().numpy()
