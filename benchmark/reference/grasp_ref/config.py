# Frozen copy of leafgrasp_tpu_torch/config.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
"""Typed configuration tree for the PyTorch/CUDA port.

A copy of the JAX package's ``config.py`` (same fields, same defaults,
same file format), kept in the port so that it imports nothing of the
JAX package. Config files written by either package load in both.

All dataclasses are frozen (hashable), so a config can key caches.
``ModelConfig.pallas_attention`` is kept for file compatibility; the
port ignores it and always gates through its attention kernel on CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics derived from a 3x4 projection matrix P.

    Mirrors reference leaf_scorer.py:19-23 / grasp_point_selector.py:145-150:
    f_norm = P[0,0], cx = P[0,2], cy = P[1,2], baseline = -P[0,3]/f_norm.
    """

    fx: float = 1750.68
    cx: float = 707.87
    cy: float = 494.07
    baseline: float = 0.0

    @staticmethod
    def from_projection(p_matrix) -> "CameraConfig":
        fx = float(p_matrix[0, 0])
        return CameraConfig(
            fx=fx,
            cx=float(p_matrix[0, 2]),
            cy=float(p_matrix[1, 2]),
            baseline=float(-p_matrix[0, 3] / fx) if fx else 0.0,
        )


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static frame geometry (reference leaf_grasp_node_v3.py:31-32)."""

    height: int = 1080
    width: int = 1440
    # Fixed upper bound on instance count so per-leaf loops become padded,
    # jit-friendly batch ops (reference loops over a dynamic leaf list).
    max_leaves: int = 16


@dataclasses.dataclass(frozen=True)
class LeafSelectionConfig:
    """Leaf-level (Pareto) selection: reference leaf_scorer.py:25-199."""

    min_leaf_area: int = 10000          # leaf_scorer.py:80
    distance_scale_m: float = 0.3       # leaf_scorer.py:117 (exp falloff)
    tall_bonus: float = 1.1             # leaf_scorer.py:157 (code says 1.1; the
                                        # comment claims 20% -- we follow code)
    clutter_weight: float = 0.35        # leaf_scorer.py:170
    distance_weight: float = 0.35
    visibility_weight: float = 0.30


@dataclasses.dataclass(frozen=True)
class GraspScoringConfig:
    """Pixel-level grasp scoring: reference grasp_point_selector.py:17-33,
    256-288, 502-701.

    NOTE the README (reference README.md:83-87) advertises weights
    25/40/15/20 which do NOT match the code; we follow the code
    (grasp_point_selector.py:272-277): 0.4 approach + 0.3 sdf +
    0.2 flatness + 0.1 accessibility, gated by (1 - stem_penalty).
    """

    approach_weight: float = 0.4
    sdf_weight: float = 0.3
    flatness_weight: float = 0.2
    accessibility_weight: float = 0.1

    # sdf_score internals (grasp_point_selector.py:526-567)
    optimal_edge_distance: float = 20.0
    sdf_interior_weight: float = 0.4
    sdf_alignment_weight: float = 0.4
    sdf_raw_weight: float = 0.2

    # isolation internals (grasp_point_selector.py:595-633)
    isolation_close_kernel: int = 30
    isolation_wide_kernel: int = 40
    isolation_close_weight: float = 0.7
    isolation_wide_weight: float = 0.3
    # "union": interference = other leaves of the full instance map (the
    #   intended behavior; 2 EDT fields per frame).
    # "union_half": same interference sets, distance fields computed at
    #   half resolution and upsampled (<~1.5 px field error feeding only
    #   the CNN patch channels; ~8x cheaper EDTs).
    # "reference_self": replicate the reference PRODUCTION path, which
    #   passes only the single-leaf mask so interference is empty and
    #   cv2.distanceTransform of the all-ones complement returns FLT_MAX
    #   -> isolation degenerates to height_pref * mask, no EDTs
    #   (leaf_grasp_node_v3.py:117-119 + grasp_point_selector.py:605-617).
    isolation_context: str = "union"
    height_pref_top: float = 1.0
    height_pref_bottom: float = 0.2
    # Major-axis angle source for the sdf alignment term
    # (grasp_point_selector.py:553-558):
    # "min_area_rect": the reference's estimate_leaf_orientation
    #   (cv2.minAreaRect of the largest contour), computed TPU-natively
    #   by ops/pca.min_area_rect -- the reference-faithful setting.
    # "pca": mask second-moment PCA -- cheaper, agrees on elongated
    #   elliptical blobs, can differ by tens of degrees on irregular
    #   ones (measured: PARITY.json orientation_probe).
    orientation_source: str = "min_area_rect"
    # Query-window sides (px) for the per-leaf distance fields: every
    # consumer of din/dclose/dwide reads leaf pixels only (patches stay
    # >= min_edge_distance - patch/2 = 4 px inside the leaf), so pass-2
    # evaluates just the leaf's bbox in the SMALLEST listed window that
    # fits (O(win^2 * W) regardless of how far the other leaves are,
    # nested lax.cond ladder); leaves larger than every window fall
    # back to the adaptive banded sweep.
    leaf_windows: Tuple[int, ...] = (320, 640)
    # > 0: additionally restrict the window pass-2's SOURCE columns to
    # +-pad around the window when provably exact (every field value on
    # the leaf is bounded by the already-computed exact maxes and by
    # half the leaf bbox's smaller side; 1-Lipschitz => the winning
    # source is within the pad). Cuts the window sweep from O(W) to
    # O(wq + 2*pad) source columns on crowded frames. 0 = off
    # (measured default pending; see PERF.md roadmap 11).
    leaf_window_src_pad: int = 0
    # Envelope-max sampling knobs (ops/edt.edt_max_argmax[_batch]); the
    # result is EXACT at any setting (coverage guard + full-sweep
    # fallback) -- these only trade scan vs refinement cost. 0 = the
    # ops defaults (stride 16 / k 1024, the r5 measured setting); the
    # pre-r5 8/2048 stays reachable for A/Bs.
    envelope_stride: int = 0
    envelope_k: int = 0
    # Interference pass-1 strategy (ops/morphology):
    # "levels" = sparse-table nested-window erosion (r5 default),
    # "runs" = per-column-offset loop; bit-identical outputs.
    dvd_impl: str = "levels"

    # accessibility internals (grasp_point_selector.py:502-524)
    access_distance_weight: float = 0.7
    access_direction_weight: float = 0.3

    # stem penalty (grasp_point_selector.py:688-701)
    stem_kernel: int = 30
    stem_bottom_fraction: float = 3.0   # bottom third

    # flatness (grasp_point_selector.py:635-657)
    flatness_gradient_scale: float = 5.0
    gaussian_kernel_size: int = 5       # leaf_grasp_node_v3.py:37

    # candidate extraction (grasp_point_selector.py:194-198, 282-288)
    min_edge_distance: float = 20.0
    stem_penalty_cutoff: float = 0.8
    top_k: int = 20
    min_candidate_distance: int = 10


@dataclasses.dataclass(frozen=True)
class MLFusionConfig:
    """CV (+) ML confidence-weighted fusion: grasp_point_selector.py:210-237."""

    patch_size: int = 32
    ml_weight_cap: float = 0.3
    ml_conf_scale: float = 0.6
    score_spread_scale: float = 3.0     # tanh(score*3)*0.5+0.5
    # "reference_minmax": the faithful serving path -- per-patch
    # min-max (grasp_point_selector.py:84-121), which MISMATCHES the
    # z-score normalization the CNN was trained under
    # (train_model.py:41-62) and leaves it out-of-distribution at
    # inference (the reference's own train/serve bug; see
    # geometry/patches.py).  "train_stats": corrected mode -- the
    # checkpoint's stored NormStats applied at serve time
    # (make_frame_fn(norm_stats=...)).
    patch_normalization: str = "reference_minmax"


@dataclasses.dataclass(frozen=True)
class PreGraspConfig:
    """Pre-grasp ray march: grasp_point_selector.py:754-819."""

    clearance_px: int = 15
    min_distance_m: float = 0.05
    max_distance_m: float = 0.10
    step_m: float = 0.01
    # point-cloud vs depth disagreement threshold for the optional 3D
    # cross-check (grasp_point_selector.py:175: 1 cm)
    cloud_threshold_m: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GraspPointCNN architecture: reference model.py:5-128."""

    in_channels: int = 9
    attention_type: str = "spatial"     # spatial | channel | hybrid | none
    encoder_filters: Tuple[int, ...] = (64, 128, 256)
    conv_dropout: float = 0.3
    fc_dropout: Tuple[float, float, float] = (0.5, 0.5, 0.4)
    se_reduction: int = 16
    # route the attention gating through the fused Pallas kernel
    # (models/attention_pallas.py); params are shared with the plain path
    pallas_attention: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Offline trainer: reference train_model.py:155-338."""

    seed: int = 42
    batch_size: int = 16
    learning_rate: float = 5e-4
    weight_decay: float = 0.01
    pos_weight: float = 2.0
    grad_clip: float = 1.0
    epochs: int = 150
    val_fraction: float = 0.2
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    min_lr: float = 1e-6
    early_stop_patience: int = 15
    early_stop_min_delta: float = 1e-3
    # data-parallel axis size hint; actual mesh comes from parallel.mesh
    data_axis: str = "data"


# The reference ships a second, "online" trainer inside the ROS node
# (ml_grasp_optimizer/trainer.py:13-17: Adam lr=1e-3 wd=0.01,
# BCEWithLogits pos_weight=1.5, batch 8, ReduceLROnPlateau). Its epoch
# loop crashes on a use-before-def (trainer.py:87 vs :93, SURVEY.md 2.4);
# this preset is the working equivalent.
ONLINE_TRAIN_CONFIG = TrainConfig(learning_rate=1e-3, batch_size=8,
                                  pos_weight=1.5, epochs=50)


@dataclasses.dataclass(frozen=True)
class VLAConfig:
    """VLA hybrid selection: reference vla_system/{hybrid_selector,
    confidence_manager,llava_processor}.py."""

    num_candidates: int = 5
    # confidence ladder (hybrid_selector.py:36-51)
    ladder: Tuple[Tuple[float, float], ...] = (
        (0.8, 0.6),
        (0.5, 0.3),
        (0.2, 0.1),
    )
    # confidence blend (confidence_manager.py:11-28)
    consistency_weight: float = 0.4
    variance_weight: float = 0.3
    magnitude_weight: float = 0.3
    history_len: int = 10

    # LoRA fine-tune (vla_trainer.py:33-43)
    lora_rank: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config tree."""

    frame: FrameConfig = FrameConfig()
    camera: CameraConfig = CameraConfig()
    leaf: LeafSelectionConfig = LeafSelectionConfig()
    grasp: GraspScoringConfig = GraspScoringConfig()
    fusion: MLFusionConfig = MLFusionConfig()
    pregrasp: PreGraspConfig = PreGraspConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    vla: VLAConfig = VLAConfig()

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()


# --------------------------------------------------------------------------
# config file IO -- the reference README advertises
# ``--config configs/baseline.yaml`` but ships no loader or configs
# (reference README.md:210, SURVEY.md section 5.6); this implements it.
# --------------------------------------------------------------------------

def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return [_to_dict(v) for v in obj]
    return obj


def _as_tuple(value):
    if isinstance(value, list):
        return tuple(_as_tuple(v) for v in value)
    return value


def _from_dict(cls, data: dict):
    """Build `cls` from a (partial) nested mapping; absent keys keep
    defaults, unknown keys raise, lists become tuples (hashability)."""
    defaults = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    kw = {}
    for name, value in data.items():
        current = getattr(defaults, name)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kw[name] = _from_dict(type(current), value)
        else:
            kw[name] = _as_tuple(value)
    return dataclasses.replace(defaults, **kw)


def load_config(path: str) -> PipelineConfig:
    """Load a PipelineConfig from a YAML or JSON file.

    Files contain a (possibly partial) nested mapping mirroring the
    dataclass tree; absent keys keep their defaults, unknown keys raise.
    """
    import json
    with open(path) as fh:
        text = fh.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        data = yaml.safe_load(text) or {}
    else:
        data = json.loads(text)
    return _from_dict(PipelineConfig, data)


def save_config(cfg: PipelineConfig, path: str) -> None:
    """Write the full config tree to YAML or JSON."""
    import json
    data = _to_dict(cfg)
    with open(path, "w") as fh:
        if path.endswith((".yaml", ".yml")):
            import yaml
            yaml.safe_dump(data, fh, sort_keys=False)
        else:
            json.dump(data, fh, indent=2)
