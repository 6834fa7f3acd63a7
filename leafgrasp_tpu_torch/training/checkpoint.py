"""Checkpoints of the port, with the JAX package's payload contract
(leafgrasp_tpu/training/checkpoint.py; reference train_model.py:316-332):
the model's ``state_dict``, the optimizer's state, the normalization
stats needed at serve time and the epoch, in one ``torch.save`` file,
plus the same side-car ``<path>.meta.json`` for host-readable metrics
and history. The port's own format: it never reads or writes orbax
(``tools/grasp_cnn_orbax_to_torch.py`` converts a JAX checkpoint).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "best_model_path"]

_NORM_KEYS = ("depth_mean", "depth_std", "score_mean", "score_std")


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.array(v, np.float32)


def best_model_path(root: str) -> str:
    return os.path.join(os.path.expanduser(root), "best_model")


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict] = None,
                    norm_stats=None, metrics: Optional[Dict] = None,
                    history: Optional[Dict] = None,
                    epoch: int = 0) -> str:
    """Write the payload atomically (a temporary file, then a rename);
    tensors are stored on the CPU. ``norm_stats`` is a ``NormStats`` or a
    dict with its four keys."""
    path = os.path.abspath(os.path.expanduser(path))
    payload = {"state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()},
               "epoch": int(epoch)}
    if optimizer_state is not None:
        payload["optimizer_state"] = optimizer_state
    if norm_stats is not None:
        stats = norm_stats._asdict() if hasattr(norm_stats, "_asdict") \
            else norm_stats
        payload["norm_stats"] = {k: torch.from_numpy(_f32(stats[k]))
                                 for k in _NORM_KEYS}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)

    meta = {"epoch": int(epoch)}
    if metrics is not None:
        meta["metrics"] = metrics
    if history is not None:
        meta["history"] = {k: v for k, v in history.items()
                           if k != "metrics"}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict:
    """The payload as saved (``state_dict``, ``epoch``, and where saved
    ``optimizer_state`` and ``norm_stats`` as numpy arrays), plus
    ``meta`` from the side-car file when it exists."""
    path = os.path.abspath(os.path.expanduser(path))
    restored = torch.load(path, map_location=map_location,
                          weights_only=True)
    if "norm_stats" in restored:
        restored["norm_stats"] = {k: v.numpy() for k, v in
                                  restored["norm_stats"].items()}
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            restored["meta"] = json.load(f)
    return restored
