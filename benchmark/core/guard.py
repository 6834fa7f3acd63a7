"""The import guard: no module of the JAX package or of JAX may be
loaded by a run. Names are compared by their top-level part whole,
because the port's package name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "leafgrasp_tpu")


def forbidden_loaded(names: Iterable[str] | None = None) -> List[str]:
    """Sorted module names whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
