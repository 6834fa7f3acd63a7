"""The grasp service's configuration (``configs/<name>.json`` with
``"model": "grasp_service"``) built twice from the same file and the
same drawn weights: for the program (``leafgrasp_tpu_torch``) and for
the plain reference (``reference/grasp_ref``, its frozen copy).

The serving loop finds a configuration's module by its ``model`` and
calls ``frame_config`` (the file whose ``pipeline`` the frame runs) and
``build_rerank`` (the leaf rerank the service calls, none here)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.inputs.weights import draw_cnn_state


def frame_config(config: dict) -> dict:
    return config


def build_rerank(config: dict, seed: int, dev, overrides, traffic):
    return None


def pipeline_config(config: dict, config_module, overrides=None):
    """The ``PipelineConfig`` of ``config_module`` (the program's
    ``config`` or the reference's copy) from the file's ``pipeline``
    tree; ``overrides`` may set the frame's height and width (CPU tests
    only)."""
    cfg = config_module._from_dict(config_module.PipelineConfig,
                                   config["pipeline"])
    o = overrides or {}
    if "frame_height" in o:
        cfg = cfg.replace(frame=dataclasses.replace(
            cfg.frame, height=int(o["frame_height"]),
            width=int(o["frame_width"])))
    return cfg


def cnn_state(cfg, seed: int, dev):
    """The CNN's weights drawn from ``seed`` on ``dev``, with the names of
    the program's ``GraspPointCNN``."""
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    with torch.device("meta"):
        template = GraspPointCNN(cfg.model).state_dict()
    template = {k: torch.empty(v.shape, dtype=v.dtype)
                for k, v in template.items()}
    return draw_cnn_state(template, seed, dev)


def program_cnn(cfg, state, dev, train: bool = False):
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    model = GraspPointCNN(cfg.model).to(dev)
    model.load_state_dict(state)
    return model.train() if train else model.eval()


def reference_cnn(ref_cfg, state, dev, train: bool = False):
    from benchmark.reference.grasp_ref.models.grasp_cnn import GraspPointCNN
    model = GraspPointCNN(ref_cfg.model).to(dev)
    model.load_state_dict(state)
    return model.train() if train else model.eval()
