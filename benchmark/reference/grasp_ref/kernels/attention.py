# Frozen copy of leafgrasp_tpu_torch/kernels/attention.py at commit 8d152a04df5e,
# imports renamed to this package; part of the benchmark's plain
# reference of the frame route (see benchmark/reference/grasp_ref/__init__.py).
# The kernel wrapper always takes its plain PyTorch version.
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

On the card the gate is a ``torch.autograd.Function``: its backward is
the kernel ``attention_gate_backward`` (same source), which computes the
gradient that XLA's autodiff of ``attention_gate_reference`` computes
(the JAX package trains through that plain gate; its Pallas kernel has
no backward). ``attention_gate_backward_plain`` writes the same formulas
in torch. On the CPU the plain forward runs and autograd differentiates
it natively.
"""

from __future__ import annotations

import torch

from benchmark.reference.grasp_ref.kernels import LAUNCHES

__all__ = ["fused_attention_gate", "attention_gate_plain",
           "attention_gate_backward", "attention_gate_backward_plain",
           "MODES"]

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


def attention_gate_backward_plain(dy, x, ws, bs, w1, b1, w2, b2,
                                  mode: str):
    """Gradient of ``attention_gate_plain`` by hand: (dx, dws, dbs, dw1,
    db1, dw2, db2) for the output gradient ``dy`` (N, HW, C). The
    gradients of a gate the mode leaves out are zeros."""
    spatial, channel = _flags(mode)
    n, hw, c = x.shape
    s = torch.sigmoid(x @ ws + bs) if spatial \
        else torch.ones((n, hw, 1), dtype=x.dtype, device=x.device)
    if channel:
        m = x.mean(dim=1)                                    # (N, C)
        a = m @ w1 + b1                                      # (N, R)
        h = torch.relu(a)
        g = torch.sigmoid(h @ w2 + b2)                       # (N, C)
    else:
        g = torch.ones((n, c), dtype=x.dtype, device=x.device)
    dyxg = dy * x * g[:, None, :]
    dx = dy * s * g[:, None, :]
    dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
    dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
    dw2, db2 = torch.zeros_like(w2), torch.zeros_like(b2)
    if spatial:
        dz = dyxg.sum(dim=2, keepdim=True) * (s * (1.0 - s))  # (N, HW, 1)
        dx = dx + dz * ws.reshape(1, 1, c)
        dws = (dz * x).sum(dim=(0, 1)).reshape(c, 1)
        dbs = dz.sum().reshape(1)
    if channel:
        du = (dy * x * s).sum(dim=1) * (g * (1.0 - g))      # (N, C)
        db2 = du.sum(dim=0)
        dw2 = h.T @ du
        da = (du @ w2.T) * (a > 0)                           # (N, R)
        db1 = da.sum(dim=0)
        dw1 = m.T @ da
        dx = dx + (da @ w1.T)[:, None, :] / hw
    return dx, dws, dbs, dw1, db1, dw2, db2


def _check_operands(x, ws, bs, w1, b1, w2, b2):
    """Raise on what the kernels do not take; returns (n, hw, c, r)."""
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
    return n, hw, c, r


def _channel_major(x) -> bool:
    return not x.is_contiguous() and x.transpose(1, 2).is_contiguous()


def _empty_like_layout(x) -> torch.Tensor:
    """An (N, HW, C) tensor laid out channel-major where x is, else
    contiguous: the layouts the kernels write."""
    n, hw, c = x.shape
    if _channel_major(x):
        return torch.empty((n, c, hw), dtype=x.dtype,
                           device=x.device).transpose(1, 2)
    return torch.empty((n, hw, c), dtype=x.dtype, device=x.device)


def _gate_forward(x, ws, bs, w1, b1, w2, b2, mode: str) -> torch.Tensor:
    """Launch the forward kernel (x on the card, mode not ``none``)."""
    spatial, channel = _flags(mode)
    n, hw, c, r = _check_operands(x, ws, bs, w1, b1, w2, b2)
    cmajor = _channel_major(x)
    if not cmajor:
        x = x.contiguous()
    out = _empty_like_layout(x)
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


def attention_gate_backward(dy, x, ws, bs, w1, b1, w2, b2, mode: str):
    """(dx, dws, dbs, dw1, db1, dw2, db2): the CUDA kernel for CUDA
    tensors (one launch: a cluster of blocks, a block an example, whose
    blocks then sum the examples' records over N in a fixed order), the
    plain version for CPU tensors. dy and x are read through their
    strides (dy may be stride 0 along HW, as the average pool's gradient
    is); dx has x's layout."""
    if x.device.type in ("cpu", "cuda"):
        return attention_gate_backward_plain(dy, x, ws, bs, w1, b1, w2, b2,
                                             mode)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    spatial, channel = _flags(mode)
    n, hw, c, r = _check_operands(x, ws, bs, w1, b1, w2, b2)
    if tuple(dy.shape) != (n, hw, c) or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"dy must be float32 {(n, hw, c)} on {x.device}")
    dx = _empty_like_layout(x)
    part = torch.empty((n, 3 * c + 2 * r + 1), dtype=torch.float32,
                       device=x.device)
    grads = torch.empty((2 * c + 1 + 2 * c * r + r,), dtype=torch.float32,
                        device=x.device)
    params = [t.contiguous() for t in (ws, bs, w1, b1, w2, b2)]
    lib = load_library()
    err = lib.attention_gate_backward(
        dy.data_ptr(), *dy.stride(), x.data_ptr(), *x.stride(),
        *[t.data_ptr() for t in params], n, hw, c, r, int(spatial),
        int(channel), dx.data_ptr(), *dx.stride(), part.data_ptr(),
        grads.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "attention_gate_backward")
    LAUNCHES["attention_gate_backward"] += 1
    dws, dbs, dw1, db1, dw2, db2 = torch.split(
        grads, [c, 1, c * r, r, r * c, c])
    return (dx, dws.view(c, 1), dbs, dw1.view(c, r), db1, dw2.view(r, c),
            db2)


class _AttentionGateFn(torch.autograd.Function):
    """The gate on the card with its gradient: the forward kernel, and
    the backward kernel for every input's gradient."""

    @staticmethod
    def forward(ctx, x, ws, bs, w1, b1, w2, b2, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, ws, bs, w1, b1, w2, b2)
        return _gate_forward(x, ws, bs, w1, b1, w2, b2, mode)

    @staticmethod
    def backward(ctx, dy):
        grads = attention_gate_backward(dy, *ctx.saved_tensors, ctx.mode)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def fused_attention_gate(x, ws, bs, w1, b1, w2, b2,
                         mode: str) -> torch.Tensor:
    """The gate above: the CUDA kernel for a CUDA tensor (differentiable
    through ``attention_gate_backward``), the plain version for a CPU
    tensor. Mode ``none`` returns x untouched (no launch)."""
    _flags(mode)
    if x.device.type in ("cpu", "cuda"):
        return attention_gate_plain(x, ws, bs, w1, b1, w2, b2, mode)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if mode == "none":
        return x
    return _AttentionGateFn.apply(x, ws, bs, w1, b1, w2, b2, mode)
