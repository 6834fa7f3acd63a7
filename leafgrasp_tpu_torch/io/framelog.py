"""Frame-log recorder/replayer, the port's own copy of
leafgrasp_tpu/io/framelog.py: a ctypes binding to native/framelog.cpp.

One compact append-only file per session -- fixed header + fixed-size
(stamp, seq, int16 mask, f32 depth) records. The reader mmaps the file:
random access is O(1) and frames come back as zero-copy numpy views.

The library is compiled from the repo's ``native/framelog.cpp`` into
``build/native/`` at first use (io/_native.py; nothing is written into
``native/``). Falls back to a numpy tofile/memmap implementation with
the identical file format when the native library is unavailable (the
two are interoperable byte-for-byte, and so are the logs of this
package and of the JAX package).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Tuple

import numpy as np

from leafgrasp_tpu_torch.io._native import load_native

__all__ = ["FrameLogWriter", "FrameLogReader", "native_available"]


_MAGIC = 0x474C464C
# v2 pads the mask payload to a 4-byte multiple so depth float32 views
# are always aligned (with h*w odd, v1 depth was 2-byte aligned).
_VERSION = 2
_HEADER = np.dtype([("magic", "<u4"), ("version", "<u4"),
                    ("height", "<u4"), ("width", "<u4"),
                    ("record_bytes", "<u8"), ("reserved", "<u8")])
_REC_HEADER = np.dtype([("stamp_us", "<i8"), ("seq", "<u8")])


def _mask_pad(h: int, w: int, version: int = _VERSION) -> int:
    return 0 if version < 2 else (4 - (h * w * 2) % 4) % 4


def _record_bytes(h: int, w: int, version: int = _VERSION) -> int:
    return _REC_HEADER.itemsize + h * w * 2 + _mask_pad(h, w, version) \
        + h * w * 4


def _load_native():
    lib = load_native("framelog")
    if lib is not None:
        lib.fl_writer_open.restype = ctypes.c_void_p
        lib.fl_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
        lib.fl_writer_append.restype = ctypes.c_int
        lib.fl_writer_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int64]
        lib.fl_writer_count.restype = ctypes.c_int64
        lib.fl_writer_count.argtypes = [ctypes.c_void_p]
        lib.fl_writer_close.restype = ctypes.c_int
        lib.fl_writer_close.argtypes = [ctypes.c_void_p]
        lib.fl_reader_open.restype = ctypes.c_void_p
        lib.fl_reader_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
        lib.fl_reader_frame.restype = ctypes.c_int
        lib.fl_reader_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.fl_reader_close.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _load_native() is not None


class FrameLogWriter:
    """Append (mask int16 HxW, depth f32 HxW, stamp) records to a log."""

    def __init__(self, path: str, height: int, width: int,
                 prefer_native: bool = True, overwrite: bool = False):
        self.path = path
        self.h, self.w = int(height), int(width)
        self._count = 0
        if not overwrite and os.path.exists(path):
            raise FileExistsError(
                f"framelog already exists at {path}; pass overwrite=True "
                "to replace it (refusing to truncate a prior recording)")
        lib = _load_native() if prefer_native else None
        self._lib = lib
        if lib is not None:
            self._handle = lib.fl_writer_open(path.encode(), self.h, self.w,
                                              1 if overwrite else 0)
            if not self._handle:
                raise OSError(f"fl_writer_open failed for {path}")
            self._f = None
        else:
            self._handle = None
            self._f = open(path, "wb")
            hdr = np.zeros((), _HEADER)
            hdr["magic"] = _MAGIC
            hdr["version"] = _VERSION
            hdr["height"], hdr["width"] = self.h, self.w
            hdr["record_bytes"] = _record_bytes(self.h, self.w)
            self._f.write(hdr.tobytes())

    def append(self, mask: np.ndarray, depth: np.ndarray,
               stamp_us: int = 0) -> None:
        mask = np.ascontiguousarray(mask, np.int16)
        depth = np.ascontiguousarray(depth, np.float32)
        if mask.shape != (self.h, self.w) or depth.shape != (self.h, self.w):
            raise ValueError(f"frame shape mismatch: {mask.shape} / "
                             f"{depth.shape} vs ({self.h}, {self.w})")
        if self._handle is not None:
            rc = self._lib.fl_writer_append(
                self._handle, mask.ctypes.data_as(ctypes.c_void_p),
                depth.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int64(int(stamp_us)))
            if rc != 0:
                raise OSError("fl_writer_append failed")
        else:
            rh = np.zeros((), _REC_HEADER)
            rh["stamp_us"], rh["seq"] = int(stamp_us), self._count
            self._f.write(rh.tobytes())
            self._f.write(mask.tobytes())
            pad = _mask_pad(self.h, self.w)
            if pad:
                self._f.write(b"\x00" * pad)
            self._f.write(depth.tobytes())
            self._f.flush()
        self._count += 1

    def __len__(self) -> int:
        return self._count

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fl_writer_close(self._handle)
            self._handle = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameLogReader:
    """mmap-backed zero-copy reader; torn trailing records are ignored."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        lib = _load_native() if prefer_native else None
        self._lib = lib
        if lib is not None:
            h = ctypes.c_int()
            w = ctypes.c_int()
            n = ctypes.c_int64()
            self._handle = lib.fl_reader_open(path.encode(),
                                              ctypes.byref(h),
                                              ctypes.byref(w),
                                              ctypes.byref(n))
            if not self._handle:
                raise OSError(f"fl_reader_open failed for {path}")
            self.h, self.w, self._count = h.value, w.value, n.value
            self._mm = None
        else:
            self._handle = None
            hdr = np.fromfile(path, dtype=_HEADER, count=1)[0]
            if hdr["magic"] != _MAGIC or not 1 <= hdr["version"] <= _VERSION:
                raise OSError(f"bad framelog header in {path}")
            self.h, self.w = int(hdr["height"]), int(hdr["width"])
            self._version = int(hdr["version"])
            rb = _record_bytes(self.h, self.w, self._version)
            if rb != int(hdr["record_bytes"]):
                raise OSError("record size mismatch")
            size = os.path.getsize(path)
            self._count = (size - _HEADER.itemsize) // rb
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return int(self._count)

    def frame(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(mask int16 view, depth f32 view, stamp_us).

        Views are zero-copy into the mmap'd file: read-only, and valid
        only while this reader stays open (copy before close() if the
        data must outlive it)."""
        if not 0 <= idx < self._count:
            raise IndexError(idx)
        n = self.h * self.w
        if self._handle is not None:
            mp = ctypes.POINTER(ctypes.c_int16)()
            dp = ctypes.POINTER(ctypes.c_float)()
            st = ctypes.c_int64()
            rc = self._lib.fl_reader_frame(self._handle,
                                           ctypes.c_int64(idx),
                                           ctypes.byref(mp),
                                           ctypes.byref(dp),
                                           ctypes.byref(st))
            if rc != 0:
                raise OSError("fl_reader_frame failed")
            mask = np.ctypeslib.as_array(mp, shape=(self.h, self.w))
            depth = np.ctypeslib.as_array(dp, shape=(self.h, self.w))
            mask.flags.writeable = False
            depth.flags.writeable = False
            return mask, depth, st.value
        off = _HEADER.itemsize + idx * _record_bytes(self.h, self.w,
                                                     self._version)
        rh = np.frombuffer(self._mm, _REC_HEADER, count=1, offset=off)[0]
        off += _REC_HEADER.itemsize
        mask = np.frombuffer(self._mm, np.int16, count=n,
                             offset=off).reshape(self.h, self.w)
        off += n * 2 + _mask_pad(self.h, self.w, self._version)
        depth = np.frombuffer(self._mm, np.float32, count=n,
                              offset=off).reshape(self.h, self.w)
        return mask, depth, int(rh["stamp_us"])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        for i in range(len(self)):
            yield self.frame(i)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fl_reader_close(self._handle)
            self._handle = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
