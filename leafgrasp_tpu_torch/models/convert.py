"""Flax GraspPointCNN variables -> the port's ``state_dict``.

Takes the Flax variables as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``, as the JAX package's
checkpoints restore them) and maps conv kernels HWIO -> OIHW, dense
kernels (in, out) -> (out, in), BatchNorm scale/bias/mean/var to
weight/bias/running_mean/running_var (both sides use epsilon 1e-5), and
the attention gate's kernels and biases as they are. Reads no files:
the port never imports the checkpoint library.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_to_torch_grasp_cnn", "grasp_cnn_flax_name"]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32).copy())


def _bn(out: dict, prefix: str, params: dict, stats: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def flax_to_torch_grasp_cnn(variables_np: dict) -> dict:
    """Flax variables (nested numpy dicts) -> GraspPointCNN state_dict."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    out: dict = {}
    n_blocks = sum(1 for k in params if k.startswith("_EncoderBlock_"))
    for b in range(n_blocks):
        p, s = params[f"_EncoderBlock_{b}"], stats[f"_EncoderBlock_{b}"]
        for j in range(2):
            conv = p[f"Conv_{j}"]
            out[f"blocks.{b}.conv{j}.weight"] = _t(
                np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
            out[f"blocks.{b}.conv{j}.bias"] = _t(conv["bias"])
            _bn(out, f"blocks.{b}.bn{j}", p[f"BatchNorm_{j}"],
                s[f"BatchNorm_{j}"])
    for name, value in params.get("attention", {}).items():
        out[f"attention.{name}"] = _t(value)
    n_dense = sum(1 for k in params if k.startswith("Dense_"))
    for d in range(n_dense):
        dense = params[f"Dense_{d}"]
        prefix = "head" if d == n_dense - 1 else f"dense.{d}"
        out[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
        out[f"{prefix}.bias"] = _t(dense["bias"])
        if d < n_dense - 1:
            _bn(out, f"dense_bn.{d}", params[f"BatchNorm_{d}"],
                stats[f"BatchNorm_{d}"])
    return out


_FLAX_LEAF = {"running_mean": "mean", "running_var": "var"}


def grasp_cnn_flax_name(key: str, n_hidden: int = 3) -> str:
    """The Flax path (``a/b/leaf``) of a GraspPointCNN ``state_dict`` key,
    the inverse of the map above; ``n_hidden`` is the number of hidden
    dense layers (the head is ``Dense_{n_hidden}``)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "blocks":                    # blocks.b.conv0 / bn1
        layer = parts[2]
        kind = "Conv" if layer.startswith("conv") else "BatchNorm"
        path = [f"_EncoderBlock_{parts[1]}", f"{kind}_{layer[-1]}"]
    elif parts[0] == "attention":
        path = ["attention"]
    elif parts[0] == "dense":
        path, kind = [f"Dense_{parts[1]}"], "Dense"
    elif parts[0] == "dense_bn":
        path, kind = [f"BatchNorm_{parts[1]}"], "BatchNorm"
    elif parts[0] == "head":
        path, kind = [f"Dense_{n_hidden}"], "Dense"
    else:
        raise KeyError(f"unknown GraspPointCNN entry {key!r}")
    if leaf == "weight" and parts[0] != "attention":
        leaf = "scale" if kind == "BatchNorm" else "kernel"
    return "/".join(path + [_FLAX_LEAF.get(leaf, leaf)])
