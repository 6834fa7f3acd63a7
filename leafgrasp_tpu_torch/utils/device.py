"""Device selection and the count of device-to-host reads.

The port runs on the card unless the caller names another device: there
is no silent fallback to the CPU. Data-dependent branches of the JAX
package (``lax.cond`` / ``while_loop`` choices) become Python branches on
a scalar read back from the device; every such read goes through
``host_read`` so a run can report how many it made.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "host_read", "host_reads",
           "reset_host_reads"]

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
    return t.detach().cpu().tolist()


def host_reads() -> int:
    return _HOST_READS[0]


def reset_host_reads() -> None:
    _HOST_READS[0] = 0
