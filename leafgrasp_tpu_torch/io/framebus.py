"""Frame-pairing ingest bus, the port's own copy of
leafgrasp_tpu/io/framebus.py: a ctypes binding to the native C++
runtime.

A lock-free triple-buffered mailbox per stream (native/framebus.cpp).
Producers (segmentation / stereo processes) never block; the consumer
atomically takes the freshest unseen (mask, depth) pair.

The library is compiled from the repo's ``native/framebus.cpp`` into
``build/native/`` at first use (io/_native.py; nothing is written into
``native/``). Falls back to a mutex-based pure-python implementation
when no compiler is available or ``prefer_native=False``, keeping the
identical API.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from leafgrasp_tpu_torch.io._native import load_native

__all__ = ["FrameBus", "native_available"]


def _load_native():
    lib = load_native("framebus")
    if lib is not None:
        lib.fb_create.restype = ctypes.c_void_p
        lib.fb_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fb_destroy.argtypes = [ctypes.c_void_p]
        lib.fb_push_mask.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.fb_push_depth.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64]
        lib.fb_try_get_pair.restype = ctypes.c_int
        lib.fb_try_get_pair.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 4
        lib.fb_stats.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    return lib


def native_available() -> bool:
    return _load_native() is not None


class _PyBus:
    """Mutex fallback with identical semantics."""

    def __init__(self, height, width):
        self._lock = threading.Lock()
        self._mask = None
        self._depth = None
        self._mask_stamp = 0
        self._depth_stamp = 0
        self.stats = dict(mask_pushed=0, mask_dropped=0, depth_pushed=0,
                          depth_dropped=0, pairs=0)

    def push_mask(self, arr, stamp):
        with self._lock:
            if self._mask is not None:
                self.stats["mask_dropped"] += 1
            self._mask = arr.copy()
            self._mask_stamp = stamp
            self.stats["mask_pushed"] += 1

    def push_depth(self, arr, stamp):
        with self._lock:
            if self._depth is not None:
                self.stats["depth_dropped"] += 1
            self._depth = arr.copy()
            self._depth_stamp = stamp
            self.stats["depth_pushed"] += 1

    def try_get_pair(self):
        with self._lock:
            if self._mask is None or self._depth is None:
                return None
            out = (self._mask, self._depth, self._mask_stamp,
                   self._depth_stamp)
            self._mask = self._depth = None
            self.stats["pairs"] += 1
            return out


class FrameBus:
    """Latest-frame pairing bus. Thread-safe: one consumer, one producer
    per stream."""

    def __init__(self, height: int, width: int, prefer_native: bool = True):
        self.height = height
        self.width = width
        self._native = _load_native() if prefer_native else None
        if self._native is not None:
            self._handle = self._native.fb_create(height, width)
            self._mask_buf = np.empty((height, width), np.int16)
            self._depth_buf = np.empty((height, width), np.float32)
        else:
            self._py = _PyBus(height, width)

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def push_mask(self, mask: np.ndarray, stamp_us: int = 0):
        mask = np.ascontiguousarray(mask, np.int16)
        if mask.shape != (self.height, self.width):
            raise ValueError(f"mask shape {mask.shape} is not "
                             f"({self.height}, {self.width})")
        if self._native is not None:
            self._native.fb_push_mask(
                self._handle, mask.ctypes.data_as(ctypes.c_void_p),
                int(stamp_us))
        else:
            self._py.push_mask(mask, stamp_us)

    def push_depth(self, depth: np.ndarray, stamp_us: int = 0):
        depth = np.ascontiguousarray(depth, np.float32)
        if depth.shape != (self.height, self.width):
            raise ValueError(f"depth shape {depth.shape} is not "
                             f"({self.height}, {self.width})")
        if self._native is not None:
            self._native.fb_push_depth(
                self._handle, depth.ctypes.data_as(ctypes.c_void_p),
                int(stamp_us))
        else:
            self._py.push_depth(depth, stamp_us)

    def try_get_pair(self) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             int, int]]:
        """Freshest unseen (mask, depth, mask_stamp, depth_stamp), or
        None when either stream has no new frame."""
        if self._native is not None:
            ms = ctypes.c_int64()
            ds = ctypes.c_int64()
            got = self._native.fb_try_get_pair(
                self._handle,
                self._mask_buf.ctypes.data_as(ctypes.c_void_p),
                self._depth_buf.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(ms), ctypes.byref(ds))
            if not got:
                return None
            return (self._mask_buf.copy(), self._depth_buf.copy(),
                    ms.value, ds.value)
        return self._py.try_get_pair()

    def stats(self) -> dict:
        if self._native is not None:
            vals = [ctypes.c_uint64() for _ in range(5)]
            self._native.fb_stats(self._handle,
                                  *[ctypes.byref(v) for v in vals])
            keys = ("mask_pushed", "mask_dropped", "depth_pushed",
                    "depth_dropped", "pairs")
            return dict(zip(keys, (v.value for v in vals)))
        return dict(self._py.stats)

    def close(self):
        if self._native is not None and self._handle:
            self._native.fb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
