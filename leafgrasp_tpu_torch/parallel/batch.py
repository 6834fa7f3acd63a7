"""Multi-rank frame processing: data-parallel batched selection, PyTorch
port of leafgrasp_tpu/parallel/batch.py.

The JAX package ``vmap``s ``select_grasp`` over a frame batch sharded on
the ``data`` axis. The port's frame path reads scalars back for its
data-dependent branches and sizes windows from them, so it does not
batch: each data rank runs the single-frame path over its ``B / D``
frames, and one ``all_gather`` brings every rank's results to every
rank as ``(B, ...)`` leaves.
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from leafgrasp_tpu_torch.parallel.collectives import Axis
from leafgrasp_tpu_torch.parallel.mesh import mesh_device
from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
from leafgrasp_tpu_torch.utils.device import _leaves, _rebuild

__all__ = ["make_batched_frame_fn"]


def _gather_results(results: list, axis: Axis):
    """Stack the per-frame result trees of this rank, gather every rank's
    stacks in one collective (each leaf as float64, exact for the
    results' bools, int32/int64 indices and float32 values) and return
    one tree of (B, ...) leaves in the first tree's dtypes."""
    per_frame = []
    for res in results:
        leaves: list = []
        _leaves(res, leaves)
        per_frame.append(leaves)
    stacked = [torch.stack(col) for col in zip(*per_frame)]
    flat = torch.cat([t.to(torch.float64).reshape(-1) for t in stacked])
    got = axis.gather(flat)                             # (D, total)
    out, pos = [], 0
    for t in stacked:
        n = t.numel()
        part = got[:, pos:pos + n].reshape(axis.size * t.shape[0],
                                           *t.shape[1:])
        out.append(part.to(t.dtype))
        pos += n
    return _rebuild(results[0], iter(out))


def make_batched_frame_fn(mesh, cfg: PipelineConfig = DEFAULT_CONFIG,
                          with_cnn: bool = False, axis: str = "data"):
    """``fn(masks (B, H, W), depths (B, H, W), cx, cy, f[, cnn])`` with
    the batch sharded over the mesh's ``axis``: every rank passes the
    whole batch and gets the whole ``FrameResult`` batch back, each leaf
    with a leading B. B must be a multiple of the axis' size. ``cnn`` is
    a GraspPointCNN in eval mode on this rank's device; ``fn.axis``
    counts the collectives."""
    ax = Axis(mesh, axis)
    frame = make_frame_fn(cfg, with_cnn=with_cnn, device=mesh_device(mesh))

    def fn(masks, depths, cx, cy, f, cnn=None):
        b = len(masks)
        if b % ax.size or len(depths) != b:
            raise ValueError(f"a batch of {b} frames ({len(depths)} "
                             f"depths) must divide the {ax.size} shards")
        n = b // ax.size
        extra = (cnn,) if with_cnn else ()
        results = [frame(masks[i], depths[i], cx, cy, f, *extra)
                   for i in range(ax.index * n, (ax.index + 1) * n)]
        return _gather_results(results, ax)

    fn.axis = ax
    return fn
