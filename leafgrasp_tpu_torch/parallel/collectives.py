"""The collectives of the port's parallel layer, over one dimension of a
device mesh.

Every parallel program of the port runs SPMD: one process per rank,
each calling the same functions on the same arguments, and each
issuing the same collectives in the same order. Only three collectives
are used, the ones the ``gloo`` backend also takes for CUDA tensors
(several ranks sharing one card run over ``gloo``, which ``nccl``
refuses): ``all_reduce`` (SUM, MAX, MIN), ``all_gather`` in its list
form and ``broadcast``. No bool tensor enters one: an "any" is a summed
int32. ``Axis`` counts the collectives it issues and their payload
bytes, so a run can report what a frame or a step moved.

``AllReduceSum``, ``CopyToAxis`` and ``GatherFromAxis`` are the
differentiable forms the data- and tensor-parallel trainer needs;
``ReduceFromAxis``, ``ShiftAlongAxis`` and ``BroadcastFromAxis`` those
of the pipeline (``parallel/pipeline.py``). Every form but
``AllReduceSum`` takes the loss to be replicated: every rank computes the
same loss from the same replicated tensors and it counts once, so a
gradient that arrives on every rank is not summed again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Axis", "AllReduceSum", "CopyToAxis", "GatherFromAxis",
           "ReduceFromAxis", "ShiftAlongAxis", "BroadcastFromAxis"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Axis:
    """One named dimension of a ``DeviceMesh`` as this rank sees it: its
    process group, its ``size``, this rank's ``index`` along it, and the
    ``calls`` and payload ``bytes`` of the collectives issued over it (an
    all_reduce moves its tensor, an all_gather its gathered result). On
    an axis of size 1 nothing is issued or counted."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = mesh.shape[mesh.mesh_dim_names.index(name)]
        self.index = mesh.get_local_rank(name)
        self.group = mesh.get_group(name)
        self.calls = 0
        self.bytes = 0

    def reset_counts(self) -> None:
        self.calls = 0
        self.bytes = 0

    def _count(self, nbytes: int) -> None:
        self.calls += 1
        self.bytes += int(nbytes)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A copy of ``t`` reduced over the axis (``op``: sum, max, min)."""
        if t.dtype == torch.bool:
            raise TypeError("no bool tensor in a collective: reduce an int")
        out = t.detach().clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            dist.all_reduce(out, op=_OPS[op], group=self.group)
            self._count(out.numel() * out.element_size())
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t, "sum")

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t, "max")

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, in axis order."""
        if t.dtype == torch.bool:
            raise TypeError("no bool tensor in a collective: gather an int")
        t = t.detach().contiguous()
        if self.size == 1:
            return t[None]
        outs = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(outs, t, group=self.group)
        self._count(t.numel() * t.element_size() * self.size)
        return torch.stack(outs)

    def differentiable_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``sum`` with the gradient of a sum (``AllReduceSum``)."""
        return AllReduceSum.apply(t, self)

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """The ``t`` of the rank ``step`` places before this one on the
        ring of the axis (index ``(index - step) % size``): one list
        ``all_gather``, as gloo has no ``send`` / ``recv`` for CUDA
        tensors."""
        if self.size == 1:
            return t.detach().clone(memory_format=torch.contiguous_format)
        return self.gather(t)[(self.index - step) % self.size]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """A copy of the ``t`` of the rank at index ``src`` of the axis."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            dist.broadcast(out, dist.get_global_rank(self.group, src),
                           group=self.group)
            self._count(out.numel() * out.element_size())
        return out


class AllReduceSum(torch.autograd.Function):
    """Sum over the axis, differentiable: every rank's output feeds every
    rank's loss, so the gradient of an input is the sum of the output
    gradients over the axis."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        return axis.sum(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.sum(grad), None


class CopyToAxis(torch.autograd.Function):
    """Identity forward; the gradient sums over the axis. It enters a
    column-sharded layer, whose shards each give part of the gradient of
    the replicated input."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.sum(grad), None


class GatherFromAxis(torch.autograd.Function):
    """Concatenate every rank's shard along the last dimension. The
    gathered output feeds computations replicated over the axis, whose
    gradients are therefore equal on every rank: a shard's gradient is
    its own columns of it."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        ctx.width = t.shape[-1]
        parts = axis.gather(t)
        return torch.cat(list(parts), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.axis.index * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class ReduceFromAxis(torch.autograd.Function):
    """Megatron's "g": sum the partial outputs of a row-sharded layer over
    the axis; the gradient passes as it is, since each rank's partial
    output feeds the one replicated loss once."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        return axis.sum(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ShiftAlongAxis(torch.autograd.Function):
    """The ring permutation ``[(i, (i + 1) % size)]`` (JAX's ``ppermute``
    of a pipeline stage's output): rank ``i`` takes rank ``i - 1``'s
    tensor. Its transpose is the reverse ring: rank ``i`` takes rank
    ``i + 1``'s gradient."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        return axis.shift(t, 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.shift(grad, -1), None


class BroadcastFromAxis(torch.autograd.Function):
    """The ``t`` of the rank at index ``src`` on every rank of the axis
    (JAX: ``psum`` of ``where(index == src, t, 0)``). The replicated
    output feeds the replicated loss once, so ``src`` takes its own
    gradient and the other ranks' ``t`` take none: no collective."""

    @staticmethod
    def forward(ctx, t, axis: Axis, src: int):
        ctx.keep = axis.index == src
        return axis.broadcast(t, src)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None, None
