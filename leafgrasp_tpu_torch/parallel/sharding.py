"""Parameter and batch sharding rules, PyTorch port of
leafgrasp_tpu/parallel/sharding.py.

Tensor-parallel rule, the JAX package's, applied to the Flax name and
orientation of each parameter: a 2-D dense kernel of a marked module
whose output dimension divides the model axis is sharded column-wise,
and the biases and int8/int4 scales of such a module follow it; every
other tensor (convolutions, norms, embeddings) is replicated. A torch
``Linear.weight`` is the transposed Flax kernel, ``(out, in)``, so its
output dimension is dim 0; quantized ``kernel_q`` codes keep the Flax
orientation.

Placements are ``torch.distributed.tensor`` ones over the (data, model)
mesh. DTensors describe the layout; the port's layers compute on plain
local tensors (``ColumnParallelLinear``, ``ColumnParallel``), so no
DTensor reaches a hand-written kernel's wrapper. Where GSPMD inserts an
all-gather after a column-sharded product, these layers gather their
output into a replicated plain tensor. ``tensor_parallel_`` puts a whole
model (``LlavaTorch``, ``TinyVLA``) into that form, the counterpart of
``shard_variables`` and ``jit`` of the JAX package's forward, generate
and training step: everything else of the model runs as it is, on every
rank.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from leafgrasp_tpu_torch.parallel.collectives import (Axis, CopyToAxis,
                                                      GatherFromAxis)
from leafgrasp_tpu_torch.parallel.mesh import data_sharding, mesh_shape
from leafgrasp_tpu_torch.vla.lora import LoRADense
from leafgrasp_tpu_torch.vla.quant import QuantDense

__all__ = ["infer_param_shardings", "shard_variables", "shard_batch",
           "ColumnParallelLinear", "ColumnParallel", "tensor_parallel_"]


# Modules whose 2D kernels shard column-wise over the model axis:
# classifier Dense layers and every transformer projection (the LoRA
# target set q/k/v/o/gate/up/down plus the LM head).
_TP_MARKERS = ("Dense", "q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj", "lm_head")


def _spec_for(path: str, shape: tuple, model_size: int) -> Optional[int]:
    """The JAX rule on a Flax path and shape: the index of the dimension
    sharded over the model axis, or None for replicated."""
    marked = any(m in path for m in _TP_MARKERS)
    if len(shape) == 2 and shape[-1] % model_size == 0 \
            and shape[-1] >= model_size and marked:
        return 1
    if len(shape) == 1 and marked \
            and ("bias" in path or "kernel_scale" in path) \
            and shape[0] % model_size == 0:
        # int8 per-output-channel scales (vla/quant.py) follow their
        # column-sharded kernel_q
        return 0
    return None


def _model_dim(key: str, tensor: torch.Tensor, flax_path: str,
               model_size: int) -> Optional[int]:
    """The torch dimension sharded over the model axis, or None."""
    transposed = tensor.dim() == 2 and key.rsplit(".", 1)[-1] == "weight"
    shape = tuple(tensor.shape)
    flax_shape = shape[::-1] if transposed else shape
    dim = _spec_for(flax_path, flax_shape, model_size)
    if dim is None:
        return None
    return tensor.dim() - 1 - dim if transposed else dim


def infer_param_shardings(state: Mapping[str, torch.Tensor], mesh,
                          flax_name: Optional[Callable[[str], str]] = None
                          ) -> dict:
    """``{key: placements}`` over the mesh's (data, model) axes for each
    entry of a ``state_dict``. ``flax_name`` maps a key to the Flax path
    of the same variable (``models.convert.grasp_cnn_flax_name``, or
    ``vla.convert.torch_to_flax_tiny_vla`` key by key), which the rule's
    markers read; by default the key with ``/`` for ``.``."""
    model_size = mesh_shape(mesh)["model"]
    flax_name = flax_name or (lambda key: key.replace(".", "/"))
    out = {}
    for key, t in state.items():
        dim = _model_dim(key, t, flax_name(key), model_size)
        out[key] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out


def _local_shard(t: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` (held on every rank)."""
    out = t
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            size = mesh_shape(mesh)[name]
            n = out.shape[p.dim] // size
            lo = mesh.get_local_rank(name) * n
            out = out.narrow(p.dim, lo, n)
    return out


def shard_variables(state: Mapping[str, torch.Tensor], mesh,
                    flax_name: Optional[Callable[[str], str]] = None):
    """(``{key: DTensor}``, ``{key: placements}``): each rank wraps its own
    shard of the full tensors it holds (every rank holds the same), so
    nothing is communicated."""
    shardings = infer_param_shardings(state, mesh, flax_name)
    return ({key: DTensor.from_local(_local_shard(t, shardings[key], mesh),
                                     mesh, shardings[key], run_check=False)
             for key, t in state.items()}, shardings)


def shard_batch(batch, mesh):
    """The leading dimension of each tensor of a tuple, list or dict
    sharded over the data axis: DTensors of this rank's rows. The batch
    must divide the data axis."""
    def put(x):
        d = mesh_shape(mesh)["data"]
        if x.shape[0] % d:
            raise ValueError(f"batch of {x.shape[0]} does not divide the "
                             f"data axis of {d}")
        return DTensor.from_local(
            _local_shard(x, data_sharding(mesh), mesh), mesh,
            data_sharding(mesh), run_check=False)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return type(batch)(put(x) for x in batch)


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` whose output features are sharded over a mesh axis:
    this rank holds ``weight`` (out / size, in) and its bias, computes
    its columns of the product on the replicated input, and gathers
    every rank's columns into a replicated plain tensor. The gradient of
    the input sums over the axis (``CopyToAxis``)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 axis: Axis):
        super().__init__()
        self.axis = axis
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = None if bias is None \
            else nn.Parameter(bias.detach().clone())

    def forward(self, x):
        y = F.linear(CopyToAxis.apply(x, self.axis), self.weight, self.bias)
        return GatherFromAxis.apply(y, self.axis)


class ColumnParallel(nn.Module):
    """A projection whose output features are sharded over a mesh axis,
    around ``inner``: this rank's slice of the layer it replaces, of the
    same class (a linear layer with or without a compute type, an int8 or
    int4 ``QuantDense``, a ``LoRADense`` or ``QuantLoRADense``). It
    computes this rank's columns on the replicated input (whose gradient
    sums over the axis) and gathers every rank's columns into a
    replicated plain tensor. An adapter's ``lora_b`` is sliced with its
    base; ``lora_a`` stays whole on every rank, each rank's columns give
    part of its gradient, and that gradient sums over the axis."""

    #: read by the VLA decode's graph route: a CUDA graph cannot hold the
    #: gather's collective, so a model holding one decodes eagerly
    graph_capturable = False

    def __init__(self, inner: nn.Module, axis: Axis):
        super().__init__()
        self.inner = inner
        self.axis = axis

    def forward(self, x):
        x = CopyToAxis.apply(x, self.axis)
        inner = self.inner
        if isinstance(inner, LoRADense) and inner.rank > 0:
            y = inner.base_forward(x) + inner.adapter_delta(
                x, CopyToAxis.apply(inner.lora_a, self.axis))
        else:
            y = inner(x)
        return GatherFromAxis.apply(y, self.axis)


def _main_weight(name: str, module: nn.Module) -> Optional[str]:
    """The ``state_dict`` key whose placement decides a projection's: its
    weight, its quantized codes, or those of a LoRA layer's base."""
    if isinstance(module, LoRADense):
        base = module.base
        return f"{name}.base." + ("kernel_q" if isinstance(base, QuantDense)
                                  else "weight")
    if isinstance(module, QuantDense):
        return f"{name}.kernel_q"
    if isinstance(module, nn.Linear):
        return f"{name}.weight"
    return None


def tensor_parallel_(model: nn.Module, mesh,
                     flax_name: Optional[Callable[[str], str]] = None
                     ) -> list:
    """Replace, in place, every projection of ``model`` whose weight the
    rule (``infer_param_shardings``, with ``flax_name``) shards over the
    model axis by a ``ColumnParallel`` around this rank's columns of it:
    the weight's (and bias's, codes' and scales') slice, cloned so that
    the full tensors can go. Everything else stays as it is, replicated,
    and every rank runs the model's own forward and generate. Its
    ``state_dict`` keys gain ``.inner`` at each replaced layer. Returns
    the names of the replaced layers."""
    tp = Axis(mesh, "model")
    specs = infer_param_shardings(model.state_dict(), mesh, flax_name)
    replaced = []
    for name, module in list(model.named_modules()):
        if any(name.startswith(r + ".") for r in replaced):
            continue
        key = _main_weight(name, module)
        if key is None or not isinstance(specs[key][1], Shard):
            continue
        for pname, p in list(module.named_parameters()):
            full = f"{name}.{pname}"
            if pname.endswith("lora_a") or not isinstance(specs[full][1],
                                                          Shard):
                continue
            owner, _, leaf = pname.rpartition(".")
            setattr(module.get_submodule(owner), leaf, nn.Parameter(
                _local_shard(p.detach(), specs[full], mesh).clone(),
                requires_grad=p.requires_grad))
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                sub.out_features = sub.weight.shape[0]
            elif isinstance(sub, QuantDense):
                sub.features = sub.kernel_q.shape[1]
        model.set_submodule(name, ColumnParallel(module, tp))
        replaced.append(name)
    return replaced
