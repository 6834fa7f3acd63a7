#!/usr/bin/env python3
"""Convert a GraspPointCNN checkpoint of the JAX package (orbax, as
``leafgrasp_tpu/training/checkpoint.py`` writes it) into the PyTorch
port's checkpoint format (``leafgrasp_tpu_torch/training/checkpoint.py``:
one ``torch.save`` file and its ``.meta.json``).

    python tools/grasp_cnn_from_orbax.py \\
        artifacts/grasp_cnn_hard/best_model build/grasp_cnn_hard/best_model

This is the one place where the JAX package's ``load_checkpoint`` meets
the port's ``flax_to_torch_grasp_cnn``; the port itself never imports
orbax or JAX. The weights, BatchNorm statistics, normalization stats,
epoch, metrics and history carry over; the optax optimizer state does
not (a fine-tune in the port starts its Adam moments afresh). The
architecture is read from the parameters' shapes and printed; load the
result with ``GraspQualityPredictor(cfg).load(path)``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def model_config_from_params(params):
    """The port's ``ModelConfig`` whose parameters have these shapes."""
    from leafgrasp_tpu_torch.config import ModelConfig
    blocks = sorted((k for k in params if k.startswith("_EncoderBlock_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    filters = tuple(int(np.shape(params[b]["Conv_0"]["kernel"])[-1])
                    for b in blocks)
    gate = params.get("attention", {})
    spatial, channel = "spatial_kernel" in gate, "squeeze_kernel" in gate
    mode = {(True, True): "hybrid", (True, False): "spatial",
            (False, True): "channel", (False, False): "none"}[
                (spatial, channel)]
    kw = {}
    if channel:
        c, r = np.shape(gate["squeeze_kernel"])
        kw["se_reduction"] = int(c) // int(r)
    return ModelConfig(attention_type=mode, encoder_filters=filters, **kw)


def restore_on_cpu(src: str) -> dict:
    """The JAX package's ``load_checkpoint`` of ``src`` onto the host's
    CPU, whatever device wrote it (the stored shardings name the writer's
    device, e.g. a TPU, which restoring would otherwise look for)."""
    import jax
    import orbax.checkpoint as ocp
    from leafgrasp_tpu.training.checkpoint import load_checkpoint
    src = os.path.abspath(os.path.expanduser(src))
    meta = ocp.StandardCheckpointer().metadata(src)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
        getattr(meta, "item_metadata", meta))
    return load_checkpoint(src, template=dict(template))


def convert(src: str, dst: str) -> str:
    """Read the orbax checkpoint ``src``, write the port's at ``dst``;
    returns the written path."""
    import jax
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    from leafgrasp_tpu_torch.training.checkpoint import save_checkpoint

    restored = restore_on_cpu(src)
    variables = jax.tree.map(np.asarray, {
        "params": restored["params"],
        "batch_stats": restored["batch_stats"]})
    meta = restored.get("meta", {})
    return save_checkpoint(
        dst, flax_to_torch_grasp_cnn(variables),
        norm_stats=restored.get("norm_stats"), metrics=meta.get("metrics"),
        history=meta.get("history"), epoch=int(restored["epoch"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="orbax checkpoint directory of the JAX "
                                "package")
    ap.add_argument("dst", help="path of the port's checkpoint file")
    args = ap.parse_args(argv)
    path = convert(args.src, args.dst)
    cfg = model_config_from_params(restore_on_cpu(args.src)["params"])
    print(f"wrote {path} (+ .meta.json); architecture {cfg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
