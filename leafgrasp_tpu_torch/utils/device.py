"""Device selection, the count of device-to-host reads, and the memory
utilities of leafgrasp_tpu/utils/device.py on ``torch.cuda``.

The port runs on the card unless the caller names another device: there
is no silent fallback to the CPU. Data-dependent branches of the JAX
package (``lax.cond`` / ``while_loop`` choices) become Python branches on
a scalar read back from the device; every such read goes through
``host_read`` so a run can report how many it made. Each blocking wait
for the device (a read, ``fetch_to_host``'s one synchronization) runs
under the span ``device_wait`` (``utils.profiler.span``).
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from leafgrasp_tpu_torch.utils.profiler import span

__all__ = ["resolve_device", "host_read", "host_reads",
           "reset_host_reads", "fetch_to_host", "setup", "device_info",
           "live_buffer_bytes", "clear_memory", "to_device"]

_HOST_READS = [0]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    return dev


def host_read(t: torch.Tensor):
    """Copy a (small) tensor to the host as Python values, counting the
    read. Scalars come back as Python numbers, others as lists."""
    _HOST_READS[0] += 1
    with span("device_wait"):
        return t.detach().cpu().tolist()


def host_reads() -> int:
    return _HOST_READS[0]


def reset_host_reads() -> None:
    _HOST_READS[0] = 0


def _leaves(obj, out: list) -> None:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            _leaves(item, out)
    elif isinstance(obj, dict):
        for item in obj.values():
            _leaves(item, out)


def _rebuild(obj, it):
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(item, it) for item in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(item, it) for item in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    return obj


def fetch_to_host(tree):
    """The same nesting of named tuples, tuples, lists and dicts with
    every tensor leaf as a numpy array, fetched together: the CUDA
    leaves are copied into pinned host buffers without blocking, then
    ONE synchronization waits for all of them (a ``.cpu()`` per leaf
    would synchronize once per leaf). Counts as one host read."""
    tensors: list = []
    _leaves(tree, tensors)
    _HOST_READS[0] += 1
    host = []
    stream = None
    for t in tensors:
        t = t.detach()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                              pin_memory=True)
            buf.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            host.append(buf)
        else:
            host.append(t)
    if stream is not None:
        with span("device_wait"):
            stream.synchronize()
    # pinned buffers are recycled by the allocator: hand out copies
    arrays = iter([np.array(h.numpy()) for h in host])
    return _rebuild(tree, arrays)


def setup(device=None) -> Dict:
    """Resolve the device (None means CUDA; raises without it), make it
    current, and return its facts."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return device_info(dev)


def device_info(device=None) -> Dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"backend": dev.type, "device_count": 1,
                "devices": [str(dev)]}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(idx)
    return {
        "backend": "cuda",
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "bytes_in_use": torch.cuda.memory_allocated(idx),
        "bytes_limit": total,
        "bytes_free": free,
    }


def live_buffer_bytes() -> int:
    """Total bytes of live tensors on every card (0 without CUDA)."""
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def clear_memory() -> None:
    """Collect garbage and return the caching allocator's unused blocks
    to the card (hygiene for a long-running service)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def to_device(array, device=None) -> torch.Tensor:
    """Host array -> tensor on ``device`` (None means CUDA)."""
    return torch.as_tensor(np.asarray(array)).to(resolve_device(device))
