"""Fused attention gate of GraspPointCNN: the kernel wrapper and its
plain version.

For x of shape (N, HW, C) (NHWC with the spatial axes flattened):

* spatial: ``x * sigmoid(x @ ws + bs)``, one gate per position;
* channel: ``x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``, one
  gate per channel (squeeze-and-excite);
* hybrid: both; none: ``x``.

Replaces the TPU kernel ``fused_attention_gate``
(leafgrasp_tpu/models/attention_pallas.py:63); the plain version is its
oracle ``attention_gate_reference`` (:26-39). The kernel source, with
its bound and design, is ``csrc/attention.cu``. The kernel reads x
through its strides where it is contiguous or the NCHW activations of
the CNN seen as (N, HW, C) (``x.transpose(1, 2)`` contiguous), and
writes its output in the same layout; any other layout is copied first.
"""

from __future__ import annotations

import torch

from leafgrasp_tpu_torch.kernels import LAUNCHES
from leafgrasp_tpu_torch.kernels.build import check, load_library

__all__ = ["fused_attention_gate", "attention_gate_plain", "MODES"]

MODES = ("none", "spatial", "channel", "hybrid")

# limits of the kernel's shared-memory arrays (csrc/attention.cu)
_MAX_HW, _MAX_C, _MAX_R = 64, 1024, 64


def _flags(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    return mode in ("spatial", "hybrid"), mode in ("channel", "hybrid")


def attention_gate_plain(x, ws, bs, w1, b1, w2, b2,
                         mode: str) -> torch.Tensor:
    """Plain PyTorch version. x: (N, HW, C); ws (C, 1), bs (1,),
    w1 (C, R), b1 (R,), w2 (R, C), b2 (C,)."""
    spatial, channel = _flags(mode)
    out = x
    if spatial:
        out = out * torch.sigmoid(x @ ws + bs)               # (N, HW, 1)
    if channel:
        squeezed = x.mean(dim=1)                             # (N, C)
        hidden = torch.relu(squeezed @ w1 + b1)
        gate = torch.sigmoid(hidden @ w2 + b2)               # (N, C)
        out = out * gate[:, None, :]
    return out


def fused_attention_gate(x, ws, bs, w1, b1, w2, b2,
                         mode: str) -> torch.Tensor:
    """The gate above: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Mode ``none`` returns x untouched (no
    launch)."""
    spatial, channel = _flags(mode)
    if x.device.type == "cpu":
        return attention_gate_plain(x, ws, bs, w1, b1, w2, b2, mode)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if mode == "none":
        return x
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError("x must be float32 (N, HW, C)")
    n, hw, c = x.shape
    r = w1.shape[1]
    shapes = {"ws": (ws, (c, 1)), "bs": (bs, (1,)), "w1": (w1, (c, r)),
              "b1": (b1, (r,)), "w2": (w2, (r, c)), "b2": (b2, (c,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{x.device}")
    if hw > _MAX_HW or c > _MAX_C or r > _MAX_R:
        raise ValueError(f"(HW, C, R) = {(hw, c, r)} beyond the kernel's "
                         f"limits {(_MAX_HW, _MAX_C, _MAX_R)}")
    cmajor = not x.is_contiguous() and x.transpose(1, 2).is_contiguous()
    if cmajor:
        out = torch.empty((n, c, hw), dtype=x.dtype,
                          device=x.device).transpose(1, 2)
    else:
        x = x.contiguous()
        out = torch.empty_like(x)
    vec = (hw * c) % 4 == 0 and x.data_ptr() % 16 == 0
    params = [t.contiguous() for t in (ws, bs, w1, b1, w2, b2)]
    lib = load_library()
    err = lib.fused_attention_gate(
        x.data_ptr(), *[t.data_ptr() for t in params], n, hw, c, r,
        int(spatial), int(channel), int(cmajor), int(vec), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "fused_attention_gate")
    LAUNCHES["fused_attention_gate"] += 1
    return out
