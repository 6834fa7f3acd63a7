"""Counters the harness installs at the program's kernel boundaries for
a traced window only: each call's operand shapes, turned into the bytes
its work needs (``core.work``). The wrapped functions are the port's
kernel wrappers, replaced in every module that holds them by name and
restored afterwards; nothing inside them changes."""

from __future__ import annotations

import contextlib
import importlib

from benchmark.core import work


def _minplus_bytes(args, kwargs, out):
    g2 = args[0]
    qcol = kwargs.get("qcol", args[1] if len(args) > 1 else None)
    band = kwargs.get("band", args[4] if len(args) > 4 else None)
    r, w = g2.shape
    return work.minplus_bytes(
        r, w, out.shape[-1], 0 if qcol is None else qcol.numel(),
        0 if band is None else band.numel())


def _rowband_bytes(args, kwargs, out):
    c, h, w = args[0].shape
    return work.rowband_bytes(c, h, w)


# (module holding the wrapper, its name, modules that import it by name,
#  the byte count of a call)
EDT_SITES = (
    ("leafgrasp_tpu_torch.kernels.minplus", "minplus_pass2",
     ("leafgrasp_tpu_torch.ops.edt",), _minplus_bytes),
    ("leafgrasp_tpu_torch.kernels.rowband", "squared_edt_rowband",
     ("leafgrasp_tpu_torch.ops.edt",), _rowband_bytes),
)


@contextlib.contextmanager
def count_calls(sites, totals: dict, key: str):
    """Within the block, add each call's count to ``totals[key]`` and one
    to ``totals[key + '_calls']``."""
    saved = []
    totals.setdefault(key, 0.0)
    totals.setdefault(key + "_calls", 0.0)
    try:
        for mod_name, fn_name, users, count in sites:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)

            def wrapped(*args, __orig=orig, __count=count, **kwargs):
                out = __orig(*args, **kwargs)
                first = out[0] if isinstance(out, tuple) else out
                if first.device.type == "cuda":
                    totals[key] += __count(args, kwargs, first)
                    totals[key + "_calls"] += 1
                return out

            for name in (mod_name,) + tuple(users):
                holder = importlib.import_module(name)
                saved.append((holder, fn_name, getattr(holder, fn_name)))
                setattr(holder, fn_name, wrapped)
        yield totals
    finally:
        for holder, fn_name, fn in reversed(saved):
            setattr(holder, fn_name, fn)
