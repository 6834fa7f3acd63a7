"""Device meshes of the port's parallel layer, PyTorch port of
leafgrasp_tpu/parallel/mesh.py.

The JAX package drives N devices from one controller through a
``jax.sharding.Mesh``. The port runs SPMD: one process per rank in a
``torch.distributed`` process group that the caller initialises, and a
``DeviceMesh`` over its ranks with the JAX package's axes:

  data  -- batch / frame-row data parallelism
  model -- tensor parallelism (column-sharded dense layers)

On CUDA the rule is the ``nccl`` backend, one card a rank. Several
ranks may share one card over ``gloo`` (``nccl`` refuses two ranks on
one GPU); the caller names that backend, nothing falls back to it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from leafgrasp_tpu_torch.utils.device import resolve_device

__all__ = ["make_mesh", "mesh_device", "mesh_shape", "data_sharding",
           "replicated", "largest_pow2_leq"]


def make_mesh(n_devices: int | None = None, model_axis: int = 1,
              device=None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the initialised process
    group; ``model_axis=1`` is pure data parallelism, and the data axis
    is ``n_devices // model_axis``. ``device=None`` means CUDA (raises
    without it); the tests pass ``"cpu"`` over ``gloo``. ``n_devices``
    must be the group's size, each rank being one device."""
    if n_devices is not None and n_devices % model_axis:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_axis={model_axis}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_axis={model_axis}")
    if n != world:
        raise ValueError(f"{n} devices asked of a process group of "
                         f"{world} ranks")
    if dev.type == "cpu" and dist.get_backend() != "gloo":
        raise ValueError("a CPU mesh needs the gloo backend")
    ranks = torch.arange(n).reshape(n // model_axis, model_axis)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{"data": D, "model": M}``, as the JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Placements that shard the leading (batch) dimension over the data
    axis and replicate over the model axis."""
    del mesh
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements that replicate over every axis."""
    return (Replicate(),) * mesh.ndim


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 1
